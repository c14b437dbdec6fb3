"""The whole request's share of the card's bf16 peak, in %: the model's
operations a map (the tower's convs over the V views, the U-Net's or the
ConvGRU cells' convs over the volume, counted from shapes) times the
traced window's maps a second, over 989 TFLOP/s."""


def read(ctx):
    if not ctx.maps:
        return None
    return 100.0 * ctx.flops_per_cluster * ctx.maps / ctx.window_s / ctx.peak_flops
