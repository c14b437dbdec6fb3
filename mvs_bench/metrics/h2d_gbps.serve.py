"""GB/s at which the images reach the card: the bytes `Predictor._tensor`
staged while the traced window's profiler recorded (the program's
`predict.staged_bytes`) over the device seconds of the window's
host-to-device copies (the profiler's `Memcpy HtoD` operations among the
trace's ten longest; the staging's are the window's only large ones)."""

from mvs_bench.spans import traced_counter


def read(ctx):
    staged = traced_counter("predict.staged_bytes")
    copies = sum(t for name, t in (ctx.profile or {}).get("device_ops", [])
                 if name.startswith("Memcpy HtoD"))
    return staged / copies / 1e9 if staged and copies else None
