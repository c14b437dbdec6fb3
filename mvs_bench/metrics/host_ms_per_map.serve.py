"""Host ms inside `Predictor.predict(..., fetch=False)` a map, over every
request of the window (the pageable host-to-device copies of
`Predictor._tensor` included)."""


def read(ctx):
    ms = ctx.record.get("host_ms")
    if not ms or not ctx.maps:
        return None
    return sum(ms) / ctx.maps
