"""CasMVSNet's share of the card's bf16 peak, in %: the operations of a map
(the FPN tower's convs over the V views and the three U-Nets', counted
from shapes with the model's own pads, `counts_cascade.model_flops`)
times the traced window's maps a second, over 989 TFLOP/s."""

from mvs_bench.counts_cascade import model_flops


def read(ctx):
    if not ctx.maps:
        return None
    flops = model_flops(ctx.cell.config, ctx.cell.op)
    return 100.0 * flops * ctx.maps / ctx.window_s / ctx.peak_flops
