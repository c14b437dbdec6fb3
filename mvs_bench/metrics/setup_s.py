"""Seconds from the process's start to the first timed call: imports,
kernels loaded (built on a checkout's first run), weights, the traffic's
pool, the program's set-up and its warm-up."""


def read(ctx):
    return ctx.record["setup_s"]
