"""Device ms a map of the operations that `model.feature_net` (UNetDS2GN)
launched: the profiler's kernels and copies whose launching host op ran
inside the `mvs_bench.features` range that forward hooks open around each
call, summed over the traced window and divided by its calls."""


def read(ctx):
    return ctx.range_ms("features")
