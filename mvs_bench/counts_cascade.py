"""CasMVSNet's operations and bytes from shapes, with the published
model's own pads (k // 2 on every side; the transposed convs' padding 1
and output padding 1), for the `casmvsnet` configuration's metrics.

As in `counts.py`: a conv's operations are 2 Cin Cout for each (output,
tap) pair whose tap reads inside the input, a transposed conv's for each
(input, tap) pair that lands inside the output; the first stage's cost
volume least bytes are its inputs read once and its output written once,
whatever kernel computes it.
"""

from __future__ import annotations

import math

from mvs_bench.counts import DTYPE_BYTES
from mvs_bench.reference import casmvsnet as ref

# the level (halvings of the images' rows) each tower layer reads
FPN_LEVELS = {"conv0_0": 0, "conv0_1": 0, "conv1_0": 0, "conv1_1": 1, "conv1_2": 1,
              "conv2_0": 1, "conv2_1": 2, "conv2_2": 2, "out1": 2, "inner1": 1, "inner2": 0,
              "out2": 1, "out3": 0}
# the level (halvings of D, h and w) each U-Net layer reads
REGNET_LEVELS = {"conv0": 0, "conv1": 0, "conv2": 1, "conv3": 1, "conv4": 2, "conv5": 2,
                 "conv6": 3, "conv7": 3, "conv9": 2, "conv11": 1, "prob": 0}


def valid_pairs(n: int, k: int, stride: int) -> int:
    """(output, tap) pairs along one axis of n inputs, padding k // 2 on
    each side, whose tap reads inside the input."""
    p = k // 2
    m = (n + 2 * p - k) // stride + 1
    return sum(1 for o in range(m) for t in range(k) if 0 <= o * stride + t - p < n)


def conv_flops(spatial, cin: int, cout: int, k: int, stride: int = 1) -> int:
    return 2 * cin * cout * math.prod(valid_pairs(n, k, stride) for n in spatial)


def deconv_flops(spatial, cin: int, cout: int) -> int:
    """`ConvTranspose3d(k3, s2, padding 1, output_padding 1)`: input i, tap t
    lands at 2i + t - 1, counted inside [0, 2n)."""
    pairs = [sum(1 for i in range(n) for t in range(3) if 0 <= 2 * i + t - 1 < 2 * n)
             for n in spatial]
    return 2 * cin * cout * math.prod(pairs)


def fpn_flops(n_images: int, height: int, width: int, base: int = 8) -> int:
    """The FPN tower over n images."""
    total = 0
    for name, cin, cout, k, stride in ref.fpn_layers(base):
        sp = (height >> FPN_LEVELS[name], width >> FPN_LEVELS[name])
        total += conv_flops(sp, cin, cout, k, stride)
    for name, cin, cout, k, _ in ref.fpn_heads(base):
        sp = (height >> FPN_LEVELS[name], width >> FPN_LEVELS[name])
        total += conv_flops(sp, cin, cout, k)
    return n_images * total


def regnet_flops(D: int, h: int, w: int, cin: int, base: int = 8) -> int:
    """One CostRegNet over a (D, h, w) volume of cin channels."""
    total = 0
    for name, kind, ci, co, stride in ref.regnet_layers(cin, base):
        sp = tuple(n >> REGNET_LEVELS[name] for n in (D, h, w))
        total += deconv_flops(sp, ci, co) if kind == "deconvbn" else conv_flops(sp, ci, co, 3,
                                                                               stride)
    return total


def stage_shapes(op: dict):
    """(D_s, h_s, w_s) of the three stages."""
    H, W = op["height"], op["width"]
    return [(D, H >> (2 - s), W >> (2 - s)) for s, D in enumerate(ref.PLANES)]


def model_flops(config: dict, op: dict) -> int:
    """Operations of one map: the tower over the V views and the three U-Nets."""
    base = config["model"]["base_filters"]
    total = fpn_flops(op["view_num"], op["height"], op["width"], base)
    for (D, h, w), cin in zip(stage_shapes(op), ref.stage_channels(base)):
        total += regnet_flops(D, h, w, cin, base)
    return total


def stage1_volume_bytes(config: dict, op: dict) -> int:
    """The first stage's cost volume: the V feature maps of 4 base channels
    at a quarter of the images read once, its D_1 plane depths and the V - 1
    projections (3 x 4 float32) read once, the D_1 x h x w x C volume
    written once."""
    e = DTYPE_BYTES[config["model"]["compute_dtype"]]
    D, h, w = stage_shapes(op)[0]
    C = ref.stage_channels(config["model"]["base_filters"])[0]
    V = op["view_num"]
    return V * h * w * C * e + D * 4 + (V - 1) * 12 * 4 + D * h * w * C * e
