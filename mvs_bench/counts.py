"""Operations and bytes from shapes, and the H100's published peaks.

A conv's operations are 2 Cin Cout for each (output, tap) pair whose tap
reads inside the input (SAME padding reads zeros, which cost nothing that
the work needs); a transposed conv's likewise for each (input, tap) pair
that lands inside the output. The cost volume's least bytes are its
inputs read once and its output written once, whatever kernel computes it.
The peaks are NVIDIA's data sheet for the H100 SXM at 700 W, dense (the
values `chip_smoke.py` uses).
"""

from __future__ import annotations

import math

from mvs_bench.reference import common
from mvs_bench.reference.mvsnet import unet_layers
from mvs_bench.reference.rmvsnet import CELLS

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}

# the level (halvings of the images' rows) each tower layer reads
TOWER_LEVELS = {
    "2dconv1_0": 0, "2dconv2_0": 1, "2dconv3_0": 2, "2dconv4_0": 3, "2dconv0_1": 0,
    "2dconv0_2": 0, "2dconv1_1": 1, "2dconv1_2": 1, "2dconv2_1": 2, "2dconv2_2": 2,
    "2dconv3_1": 3, "2dconv3_2": 3, "2dconv4_1": 4, "2dconv4_2": 4, "2dconv5_0": 4,
    "2dconv5_1": 3, "2dconv5_2": 3, "2dconv6_0": 3, "2dconv6_1": 2, "2dconv6_2": 2,
    "2dconv7_0": 2, "2dconv7_1": 1, "2dconv7_2": 1, "2dconv8_0": 1, "2dconv8_1": 0,
    "2dconv8_2": 0, "conv9_0": 0, "conv9_1": 1, "conv9_2": 1, "conv10_0": 1, "conv10_1": 2,
    "conv10_2": 2}
# the level (halvings of D, h and w) each U-Net layer reads
UNET_LEVELS = {"3dconv1_0": 0, "3dconv2_0": 1, "3dconv3_0": 2, "3dconv0_1": 0,
               "3dconv1_1": 1, "3dconv2_1": 2, "3dconv3_1": 3, "3dconv4_0": 3,
               "3dconv5_0": 2, "3dconv6_0": 1, "3dconv6_2": 0}


def valid_pairs(n: int, k: int, stride: int) -> int:
    """(output, tap) pairs of a SAME conv along one axis of n inputs whose
    tap reads inside the input."""
    lo, _ = common.same_pads(n, k, stride)
    m = -(-n // stride)
    return sum(1 for o in range(m) for t in range(k) if 0 <= o * stride + t - lo < n)


def conv_flops(spatial, cin: int, cout: int, k: int, stride: int = 1) -> int:
    """Operations of one SAME conv over an input of `spatial` extents."""
    return 2 * cin * cout * math.prod(valid_pairs(n, k, stride) for n in spatial)


def deconv_flops(spatial, cin: int, cout: int, k: int = 3) -> int:
    """Operations of one k3 s2 transposed conv with output 2n per axis
    (flax's SAME: out[2i + d] takes k[2 - d] x[i], d = 0..2): each (input,
    tap) pair whose output lies in [0, 2n)."""
    pairs = [sum(1 for i in range(n) for d in range(k) if 0 <= 2 * i + d < 2 * n)
             for n in spatial]
    return 2 * cin * cout * math.prod(pairs)


def _level(n: int, level: int) -> int:
    for _ in range(level):
        n = -(-n // 2)
    return n


def tower_flops(n_images: int, height: int, width: int, base: int = 8) -> int:
    """UNetDS2GN over n images."""
    total = 0
    for name, kind, cin, cout, k, stride, _ in common.tower_layers(base):
        lv = TOWER_LEVELS[name]
        sp = (_level(height, lv), _level(width, lv))
        total += (deconv_flops(sp, cin, cout, k) if kind == "deconvgn"
                  else conv_flops(sp, cin, cout, k, stride))
    return n_images * total


def unet_flops(D: int, h: int, w: int, cin: int = 32, base: int = 8) -> int:
    """RegNetUS0 over one (D, h, w) volume of cin channels."""
    total = 0
    for name, kind, ci, co, stride in unet_layers(cin, base):
        lv = UNET_LEVELS[name]
        sp = tuple(_level(n, lv) for n in (D, h, w))
        total += deconv_flops(sp, ci, co) if kind == "deconvbn" else conv_flops(sp, ci, co, 3,
                                                                               stride)
    return total


def gru_flops(D: int, h: int, w: int, cin: int = 32) -> int:
    """The three ConvGRU cells and the projection over D planes."""
    total, c = 0, cin
    for _, f in CELLS:
        total += conv_flops((h, w), c + f, 2 * f, 3) + conv_flops((h, w), c + f, f, 3)
        c = f
    return D * (total + conv_flops((h, w), c, 1, 3))


def cost_volume_bytes(views: int, h: int, w: int, C: int, D: int, dtype: str) -> int:
    """The V feature maps and the homographies read once, the D x h x w x C
    volume written once."""
    e = DTYPE_BYTES[dtype]
    return views * h * w * C * e + (views - 1) * D * 9 * 4 + D * h * w * C * e


def model_flops(config: dict, op: dict) -> int:
    """Operations of one forward pass over one cluster (one map): the tower
    over the V views, then the U-Net or the GRU cells over the volume."""
    base = config["model"]["base_filters"]
    H, W, D, V = op["height"], op["width"], op["max_d"], op["view_num"]
    h, w = H // 4, W // 4
    flops = tower_flops(V, H, W, base)
    if config["model"]["regularization"] == "GRU":
        return flops + gru_flops(D, h, w, 4 * base)
    return flops + unet_flops(D, h, w, 4 * base, base)
