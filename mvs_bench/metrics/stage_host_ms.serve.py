"""Host ms a map inside the program's `mvsnet.predict.stage` span: the
five inputs of `Predictor.predict` made float32 device tensors in
`Predictor._tensor` (the host copy and the host-to-device copies, their
waits for the stream included), on the host clock as the program tallies
its spans while the traced window's profiler records, over their calls."""

from mvs_bench.spans import traced_span


def read(ctx):
    s = traced_span("mvsnet.predict.stage")
    return 1e3 * s["host_s"] / s["calls"] if s else None
