"""1 - the union of the device's kernel and copy intervals (torch.profiler)
over the traced window, in %."""


def read(ctx):
    prof = ctx.profile
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1 - prof["busy_s"] / ctx.window_s)
