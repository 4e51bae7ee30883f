"""Set-up: process start to the window's opening (loading, deploying the
weights from the seed, building the engine, the capture and the warm-up
traffic)."""


def read(ctx):
    return ctx["setup_s"]
