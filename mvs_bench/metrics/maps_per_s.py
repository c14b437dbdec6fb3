"""Depth maps fetched to the host over the whole window, over the window."""


def read(ctx):
    if not ctx.maps:
        return None
    return ctx.maps / ctx.window_s
