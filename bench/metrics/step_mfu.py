"""Model step: the whole step's share of the H100's peaks. The least time
the work of a stretch of steps run after the window could take
(``roofline.step_calls``: each call bound by bytes at 3.35 TB/s or flops
at its precision's peak; a MoE step's experts are those its routes
select) over those steps' replays as CUDA events measured them, in
percent. The stretch runs outside the profiler, which stretches a
replay's span (about a third in OPT-6.7B)."""


def read(ctx):
    rl, timed = ctx["roofline"], ctx["timed"]
    if timed is None:
        return None
    least = spans = 0.0
    for work, ev in zip(timed.works, timed.replays):
        if ev is not None:
            least += rl.least_time(rl.step_calls(ctx["model"], work))
            spans += ev[0].elapsed_time(ev[1]) / 1e3
    if least <= 0 or spans <= 0:
        return None
    return 100.0 * least / spans
