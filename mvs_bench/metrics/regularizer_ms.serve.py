"""Device ms a map of the operations that the regularizer (`model.regnet`,
RegNetUS0, or `model.gru_sweep`, the ConvGRU sweep with its
winner-take-all) launched: the profiler's kernels and copies launched
inside the `mvs_bench.regularizer` range, summed over the traced window
and divided by its calls."""


def read(ctx):
    return ctx.range_ms("regularizer")
