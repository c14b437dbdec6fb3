"""Device ms a map of the operations that CasMVSNet's FPN tower
(`model.feature_net`, called once a map) launched: the profiler's kernels
and copies whose launching host op ran inside the `mvs_bench.features`
range that forward hooks open around each call, summed over the traced
window and divided by its calls: the same reading as `features_ms.serve`,
under the cascade's own name."""


def read(ctx):
    return ctx.range_ms("features")
