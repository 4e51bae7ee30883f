"""DRAM attention (``kernels/paged_attn.py``): the paged-attention
kernels' share of their roofline over the profiled steps, in percent:
each request's cached K/V read once, each lane's QK and PV over it."""
from bench.metrics_common import kernel_share


def read(ctx):
    return kernel_share(ctx, "paged_attn")
