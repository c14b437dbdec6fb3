"""Host ms a map inside the program's `mvsnet.predict.forward` span: the
model's launch path (the tower, the cost volume, the U-Net or the GRU
sweep's replays, the tail), on the host clock as the program tallies its
spans while the traced window's profiler records, over their calls."""

from mvs_bench.spans import traced_span


def read(ctx):
    s = traced_span("mvsnet.predict.forward")
    return 1e3 * s["host_s"] / s["calls"] if s else None
