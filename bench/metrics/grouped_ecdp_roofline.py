"""Flash tier, experts (``kernels/grouped_ecdp.py``): the grouped ECDP
kernels' share of their roofline over the profiled steps, in percent."""
from bench.metrics_common import kernel_share


def read(ctx):
    return kernel_share(ctx, "grouped_ecdp")
