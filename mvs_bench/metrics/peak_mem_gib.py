"""`torch.cuda.max_memory_allocated` over the window, after a reset at its start, in GiB."""


def read(ctx):
    peak = ctx.record.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
