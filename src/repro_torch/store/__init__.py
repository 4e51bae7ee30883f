"""FlashStore: the host-resident, page-granular flash tier and its
streaming onto the device — the port of ``repro/store`` for dense layer
groups. ``PageStore`` serializes deployed FlashWeights into
plane-interleaved 16 KiB NAND pages (host numpy, or an mmap'd die image);
``WeightPagePool`` holds raw pages on the device; ``LayerStreamer`` +
``ResidencyCache`` stream layer groups under the serving engine's compute.
"""
from repro_torch.store.page_pool import WeightPagePool
from repro_torch.store.pagestore import (PageStore, StoreRef, drop_store_refs,
                                         graft_store_refs)
from repro_torch.store.streamer import (LayerStreamer, ResidencyCache,
                                        StreamConfig)

__all__ = ["PageStore", "StoreRef", "LayerStreamer", "ResidencyCache",
           "StreamConfig", "WeightPagePool", "drop_store_refs",
           "graft_store_refs"]
