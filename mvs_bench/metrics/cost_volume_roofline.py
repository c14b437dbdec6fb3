"""The cost volume's least time over its stage's device time, in %: the
V feature maps and the homographies read once and the D x h x w x C
volume written once at 3.35 TB/s, over the device ms a map of the
operations launched between the tower's exit and the regularizer's entry
(the `mvs_bench.cost_volume` range: the homographies and K1). Counted from
shapes, whatever kernel implements the stage."""


def read(ctx):
    ms = ctx.range_ms("cost_volume")
    if not ms:
        return None
    return 100.0 * (ctx.cost_volume_bytes / ctx.hbm_bytes_per_s * 1e3) / ms
