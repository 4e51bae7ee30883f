"""What the per-layer readers share: a kernel's roofline share over the
profiled segments."""
from __future__ import annotations


def kernel_share(ctx, kernel: str):
    """The least time of ``kernel``'s calls in the profiled steps
    (``roofline``) over the device time of its profile group, in percent;
    None where the steps hold no such call or the profile no such
    kernel."""
    rl, dt = ctx["roofline"], ctx["devtrace"]
    least = measured = 0.0
    for seg in ctx["segments"]:
        least += sum(rl.least_time(rl.step_calls(ctx["model"], w), kernel)
                     for w in seg.works)
        measured += seg.group_s().get(dt.KERNEL_GROUPS[kernel], 0.0)
    if least <= 0 or measured <= 0:
        return None
    return 100.0 * least / measured
