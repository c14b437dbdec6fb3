"""Device ms a map of the operations that CasMVSNet's three U-Nets
(`model.regnet`, called once a stage) launched: the profiler's kernels and
copies launched inside the `mvs_bench.regularizer` range, summed over the
traced window and divided by its maps (the range's calls over the
configuration's stages)."""


def read(ctx):
    prof = ctx.profile or {}
    seconds = prof.get("range_s", {}).get("regularizer")
    calls = prof.get("range_calls", {}).get("regularizer")
    stages = len(ctx.cell.config["stages"]["planes"])
    return 1e3 * seconds * stages / calls if seconds and calls else None
