"""Flash tier (``core/erdpe.py`` -> ``kernels/ecdp.py``: the FFN, lm_head
and Algorithm 2's Q/O flash copies): the ECDP kernels' share of their
roofline over the profiled steps, in percent."""
from bench.metrics_common import kernel_share


def read(ctx):
    return kernel_share(ctx, "ecdp")
