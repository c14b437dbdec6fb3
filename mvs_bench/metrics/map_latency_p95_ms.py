"""The 95th percentile over every request of the window of the time from
its dispatch (before `predict`) to its maps on the host (after the
writer's fetch), in ms."""


def read(ctx):
    lat = ctx.record.get("latencies_s")
    if not lat:
        return None
    from mvs_bench.harness import percentile
    return percentile(lat, 95) * 1e3
