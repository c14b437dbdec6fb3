"""Host ms a map inside the program's `mvsnet.cascade.stage` spans (the
cascade's three stages: planes, cost volume, U-Net and regression
launched), on the host clock as the program tallies its spans while the
traced window's profiler records, over the maps (the spans' calls over
the configuration's stages)."""

from mvs_bench.spans import traced_span


def read(ctx):
    s = traced_span("mvsnet.cascade.stage")
    if not s:
        return None
    stages = len(ctx.cell.config["stages"]["planes"])
    return 1e3 * s["host_s"] * stages / s["calls"]
