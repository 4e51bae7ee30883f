"""FlashStore: the host-resident, page-granular flash tier and its
streaming onto the device — the port of ``repro/store``.
``PageStore`` serializes deployed FlashWeights into plane-interleaved
16 KiB NAND pages (host numpy, or an mmap'd die image); ``WeightPagePool``
holds raw pages on the device (``ShardedWeightPagePool``: partitioned
over the shards of a tensor-parallel mesh); ``LayerStreamer`` +
``ResidencyCache`` stream layer groups under the serving engine's compute; ``ExpertCache`` +
``ExpertPrefetcher`` page a MoE model's routed experts.
"""
from repro_torch.store.expert_cache import ExpertCache, ExpertPrefetcher
from repro_torch.store.page_pool import (ShardedWeightPagePool,
                                         WeightPagePool)
from repro_torch.store.pagestore import (PageStore, StoreRef, drop_store_refs,
                                         graft_store_refs)
from repro_torch.store.streamer import (LayerStreamer, ResidencyCache,
                                        StreamConfig)

__all__ = ["ExpertCache", "ExpertPrefetcher", "PageStore", "StoreRef",
           "LayerStreamer", "ResidencyCache", "ShardedWeightPagePool",
           "StreamConfig", "WeightPagePool", "drop_store_refs",
           "graft_store_refs"]
