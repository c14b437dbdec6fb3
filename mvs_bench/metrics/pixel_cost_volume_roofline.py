"""CasMVSNet's first-stage cost volume: its least time over its stage's
device time, in %. The least time: the V 32-channel feature maps at a
quarter of the images read once, the 48 plane depths and the projections
read once, the 48 x h x w x 32 volume written once, at 3.35 TB/s
(`counts_cascade.stage1_volume_bytes`), over the device ms a map of the
operations launched between the tower's exit and the first U-Net's entry
(the `mvs_bench.cost_volume` range: the stage's planes, projections and
volume). Counted from shapes, whatever implements the stage."""

from mvs_bench.counts_cascade import stage1_volume_bytes


def read(ctx):
    ms = ctx.range_ms("cost_volume")
    if not ms:
        return None
    least_ms = stage1_volume_bytes(ctx.cell.config, ctx.cell.op) / ctx.hbm_bytes_per_s * 1e3
    return 100.0 * least_ms / ms
