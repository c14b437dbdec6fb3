"""The device's idle time that the trace's breakdown puts down to the
program's `mvsnet.predict.stage` span (the idle gaps whose middle falls
inside it and inside no op or range nested in it: `trace.read_profile`'s
`idle_gaps`), over the traced window, in %: the share of
`device_idle.serve` spent while the host stages a request's inputs."""


def read(ctx):
    gaps = [t for name, t in (ctx.profile or {}).get("idle_gaps", [])
            if name == "mvsnet.predict.stage"]
    return 100.0 * sum(gaps) / ctx.window_s if gaps else None
