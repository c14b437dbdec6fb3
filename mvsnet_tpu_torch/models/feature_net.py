"""2D feature towers (counterpart of mvsnet_tpu/models/feature_net.py).

  * UNetDS2GN, the production tower every graph uses: a 2D U-Net (4
    stride-2 levels, skip concats on the channel axis, group norms) then
    two stride-2 group-norm conv blocks: (B, H, W, 3) -> (B, H/4, W/4,
    4 * base) in the compute dtype, base = max(1, int(8 / div)).
    `forward_blocks` runs it on this rank's rows over 'space' (the layout
    JAX's partitioned programs give it: mvsnet_tpu/models/mvsnet.py:113-114
    constrains the tower's output over 'space', and GSPMD splits every
    layer's rows with halos); `tower_split` decides whether it can.
  * UniNetDS2 / UniNetDS2GN, the reference's simpler 8-layer towers with
    batch or group norm (mvsnetworks.py:17-50): exported, no graph builds
    them.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

import torch
from torch import nn

from mvsnet_tpu_torch.config import scaled_filters
from mvsnet_tpu_torch.models.layers import Conv, ConvBN, ConvGN, DeconvGN
from mvsnet_tpu_torch.parallel import halo
from mvsnet_tpu_torch.parallel.mesh import AxisSplit, Mesh

logger = logging.getLogger(__name__)

# UNetDS2GN's layers: (name, the level of its input (the images' rows halve
# once a level), the halo kind of its op); IMAGE_LAYERS read the images
TOWER_LAYERS = (
    ("2dconv1_0", 0, "s2"), ("2dconv2_0", 1, "s2"), ("2dconv3_0", 2, "s2"),
    ("2dconv4_0", 3, "s2"), ("2dconv0_1", 0, "s1"), ("2dconv0_2", 0, "s1"),
    ("2dconv1_1", 1, "s1"), ("2dconv1_2", 1, "s1"), ("2dconv2_1", 2, "s1"),
    ("2dconv2_2", 2, "s1"), ("2dconv3_1", 3, "s1"), ("2dconv3_2", 3, "s1"),
    ("2dconv4_1", 4, "s1"), ("2dconv4_2", 4, "s1"), ("2dconv5_0", 4, "up"),
    ("2dconv5_1", 3, "s1"), ("2dconv5_2", 3, "s1"), ("2dconv6_0", 3, "up"),
    ("2dconv6_1", 2, "s1"), ("2dconv6_2", 2, "s1"), ("2dconv7_0", 2, "up"),
    ("2dconv7_1", 1, "s1"), ("2dconv7_2", 1, "s1"), ("2dconv8_0", 1, "up"),
    ("2dconv8_1", 0, "s1"), ("2dconv8_2", 0, "s1"), ("conv9_0", 0, "s2k5"),
    ("conv9_1", 1, "s1"), ("conv9_2", 1, "s1"), ("conv10_0", 1, "s2k5"),
    ("conv10_1", 2, "s1"), ("conv10_2", 2, "s1"))
IMAGE_LAYERS = ("2dconv1_0", "2dconv0_1")
FEATURE_LEVEL = 2      # the output's level: H/4 rows


def output_level(level: int, kind: str) -> int:
    """The level of a layer's output from its input's level and kind."""
    return level - 1 if kind == "up" else level + (kind != "s1")


def tower_split(mesh: Mesh, rows: AxisSplit, height: int) -> Optional[AxisSplit]:
    """The image rows' split over 'space' whose level 2 is `rows` (the
    cost volume's feature rows, so its starts are 4x theirs), or None,
    with a warning, where the tower cannot run on it: the feature rows do
    not split though the mesh has 'space' ranks, the images are not 4x
    the feature rows, or some rank would hold fewer rows than a halo reads
    at some level. The tower then runs whole on every rank, as JAX's
    `constrain` drops an axis that does not divide."""
    sp = mesh.axis_size("space")
    if sp == 1:
        return None
    split = rows.finer(FEATURE_LEVEL)
    ops = [(kind, lv) for name, lv, kind in TOWER_LAYERS if name not in IMAGE_LAYERS]
    if rows.n == 1:
        why = "the feature rows do not split"
    elif split.extent(0) != height:
        why = f"{height} image rows are not 4x the {rows.size} feature rows"
    elif not halo.fits(split, ops):
        why = "some rank would hold fewer rows than a halo reads at some level"
    else:
        return split
    logger.warning("UNetDS2GN: %d image rows over %d 'space' ranks: %s; every rank runs "
                   "the whole tower and keeps its rows", height, sp, why)
    return None


def norm_sum(mesh: Mesh, axis: str, t):
    """A group norm's per-channel sums and count on a block, summed over
    the ranks of `axis`: one collective, differentiable (its backward sums
    the cotangents over the same ranks)."""
    return mesh.all_reduce_grad(t, axis)


class _UniNetDS2Body(nn.Module):
    """conv0_0 .. conv2_1 (norm + ReLU), then conv2_2 without norm or bias:
    (B, H, W, 3) -> (B, H/4, W/4, 4 * base)."""

    def __init__(self, block, network_mode: str = "normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = scaled_filters(8, network_mode)
        self.dtype = dtype
        # (name, in, out, kernel, stride), flax's names (feature_net.py:26-65)
        for name, cin, f, k, s in (("conv0_0", 3, b, 3, 1), ("conv0_1", b, b, 3, 1),
                                   ("conv1_0", b, b * 2, 5, 2), ("conv1_1", b * 2, b * 2, 3, 1),
                                   ("conv1_2", b * 2, b * 2, 3, 1),
                                   ("conv2_0", b * 2, b * 4, 5, 2),
                                   ("conv2_1", b * 4, b * 4, 3, 1)):
            self.add_module(name, block(cin, f, k, s, rank=2, dtype=dtype))
        self.conv2_2 = Conv(b * 4, b * 4, 3, 1, relu=False, use_bias=False, dtype=dtype)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        for m in self.children():
            x = m(x)
        return x


class UniNetDS2(_UniNetDS2Body):
    """The 8-layer downsample-by-4 tower with batch norm (feature_net.py:26;
    reference: mvsnetworks.py:17-32); the norms use batch statistics in
    train mode, as JAX's with training=True."""

    def __init__(self, network_mode: str = "normal", dtype: Optional[torch.dtype] = None):
        super().__init__(ConvBN, network_mode, dtype)


class UniNetDS2GN(_UniNetDS2Body):
    """UniNetDS2 with group norm (feature_net.py:47; reference:
    mvsnetworks.py:35-50)."""

    def __init__(self, network_mode: str = "normal", dtype: Optional[torch.dtype] = None):
        super().__init__(ConvGN, network_mode, dtype)


class UNetDS2GN(nn.Module):
    def __init__(self, network_mode: str = "normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = scaled_filters(8, network_mode)
        self.dtype = dtype
        # names follow the JAX module tree, so converted weights load as they are
        layers = [
            ("2dconv1_0", ConvGN(3, b * 2, 3, 2, dtype=dtype)),
            ("2dconv2_0", ConvGN(b * 2, b * 4, 3, 2, dtype=dtype)),
            ("2dconv3_0", ConvGN(b * 4, b * 8, 3, 2, dtype=dtype)),
            ("2dconv4_0", ConvGN(b * 8, b * 16, 3, 2, dtype=dtype)),
            ("2dconv0_1", ConvGN(3, b, 3, 1, dtype=dtype)),
            ("2dconv0_2", ConvGN(b, b, 3, 1, dtype=dtype)),
            ("2dconv1_1", ConvGN(b * 2, b * 2, 3, 1, dtype=dtype)),
            ("2dconv1_2", ConvGN(b * 2, b * 2, 3, 1, dtype=dtype)),
            ("2dconv2_1", ConvGN(b * 4, b * 4, 3, 1, dtype=dtype)),
            ("2dconv2_2", ConvGN(b * 4, b * 4, 3, 1, dtype=dtype)),
            ("2dconv3_1", ConvGN(b * 8, b * 8, 3, 1, dtype=dtype)),
            ("2dconv3_2", ConvGN(b * 8, b * 8, 3, 1, dtype=dtype)),
            ("2dconv4_1", ConvGN(b * 16, b * 16, 3, 1, dtype=dtype)),
            ("2dconv4_2", ConvGN(b * 16, b * 16, 3, 1, dtype=dtype)),
            ("2dconv5_0", DeconvGN(b * 16, b * 8, dtype=dtype)),
            ("2dconv5_1", ConvGN(b * 16, b * 8, 3, 1, dtype=dtype)),
            ("2dconv5_2", ConvGN(b * 8, b * 8, 3, 1, dtype=dtype)),
            ("2dconv6_0", DeconvGN(b * 8, b * 4, dtype=dtype)),
            ("2dconv6_1", ConvGN(b * 8, b * 4, 3, 1, dtype=dtype)),
            ("2dconv6_2", ConvGN(b * 4, b * 4, 3, 1, dtype=dtype)),
            ("2dconv7_0", DeconvGN(b * 4, b * 2, dtype=dtype)),
            ("2dconv7_1", ConvGN(b * 4, b * 2, 3, 1, dtype=dtype)),
            ("2dconv7_2", ConvGN(b * 2, b * 2, 3, 1, dtype=dtype)),
            ("2dconv8_0", DeconvGN(b * 2, b, dtype=dtype)),
            ("2dconv8_1", ConvGN(b * 2, b, 3, 1, dtype=dtype)),
            ("2dconv8_2", ConvGN(b, b, 3, 1, dtype=dtype)),
            ("conv9_0", ConvGN(b, b * 2, 5, 2, dtype=dtype)),
            ("conv9_1", ConvGN(b * 2, b * 2, 3, 1, dtype=dtype)),
            ("conv9_2", ConvGN(b * 2, b * 2, 3, 1, dtype=dtype)),
            ("conv10_0", ConvGN(b * 2, b * 4, 5, 2, dtype=dtype)),
            ("conv10_1", ConvGN(b * 4, b * 4, 3, 1, dtype=dtype)),
            ("conv10_2", Conv(b * 4, b * 4, 3, 1, relu=False, use_bias=False,
                              dtype=dtype)),
        ]
        for name, module in layers:
            self.add_module(name, module)

    def forward(self, x, layer=None):
        """(N, H, W, 3) -> (N, H/4, W/4, 4 * base). `layer(name, x)`, where
        given, runs each layer in place of its module's call
        (`forward_blocks` passes the blocked ones)."""
        L = self._modules
        run = layer or (lambda name, t: L[name](t))
        if self.dtype is not None:
            x = x.to(self.dtype)
        c1_0 = run("2dconv1_0", x)
        c2_0 = run("2dconv2_0", c1_0)
        c3_0 = run("2dconv3_0", c2_0)
        c4_0 = run("2dconv4_0", c3_0)
        c0_2 = run("2dconv0_2", run("2dconv0_1", x))
        c1_2 = run("2dconv1_2", run("2dconv1_1", c1_0))
        c2_2 = run("2dconv2_2", run("2dconv2_1", c2_0))
        c3_2 = run("2dconv3_2", run("2dconv3_1", c3_0))
        c4_2 = run("2dconv4_2", run("2dconv4_1", c4_0))
        c5_0 = run("2dconv5_0", c4_2)
        c5_2 = run("2dconv5_2", run("2dconv5_1", torch.cat([c5_0, c3_2], dim=-1)))
        c6_0 = run("2dconv6_0", c5_2)
        c6_2 = run("2dconv6_2", run("2dconv6_1", torch.cat([c6_0, c2_2], dim=-1)))
        c7_0 = run("2dconv7_0", c6_2)
        c7_2 = run("2dconv7_2", run("2dconv7_1", torch.cat([c7_0, c1_2], dim=-1)))
        c8_0 = run("2dconv8_0", c7_2)
        c8_2 = run("2dconv8_2", run("2dconv8_1", torch.cat([c8_0, c0_2], dim=-1)))
        c9_2 = run("conv9_2", run("conv9_1", run("conv9_0", c8_2)))
        c10_1 = run("conv10_1", run("conv10_0", c9_2))
        return run("conv10_2", c10_1)

    def forward_blocks(self, x, mesh: Mesh, split: AxisSplit):
        """This rank's rows of `forward(x)`, x (N, H, W, 3) whole on every
        rank (the images), `split` the image rows' split over 'space'
        (`tower_split`): each layer's output is the rank's block of its
        level, (N, rows, W / 2^level, C), level 2 the cost volume's rows.
        Eval or training, the same layers and state dict.

        Each conv runs on its input's block extended by the rows its index
        rule reads (`parallel/halo.halo_conv` / `halo_deconv`, K6 and K7 at
        explicit pads, `ConvFn` / `DeconvFn` under autograd): one exchange
        over 'space' a layer, none for the two convs on the images, which
        cut the rows they read from the images locally. Each group norm
        sums its statistics over 'space' (`norm_sum`) as the whole map's
        norm computes them (`layers.group_norm_core`): in float32 its two
        passes, the mean and then the squares about it (62 sums a call);
        in bfloat16 the exact float64 sums of x and x^2 at once (31), so
        the blocks' statistics are the whole map's bit for bit. A call
        makes 30 exchanges and those sums; training as many again backward
        (the exchanges return the halo rows' cotangents to their owners,
        the sums sum the cotangents over 'space'). In float32 one sum a
        norm (each block's count, sum and squares about its own mean,
        combined by Chan's formula) reorders the variance's arithmetic: the
        tower's outputs then move by ~1e-6 of their scale and the blocked
        train step's gradients past 1e-4 of a leaf against one device's
        (tests/test_torch_parallel.py). The skip concats join blocks of one
        level: a transposed conv's output is its block at the level above,
        as the skip's is. The 'depth' ranks of a 'space' rank compute the
        same rows."""
        L = self._modules
        levels = {name: (lv, kind) for name, lv, kind in TOWER_LAYERS}
        splits = (split, None)

        def stat_sum(t):
            return norm_sum(mesh, split.axis, t)

        def layer(name, t):
            lv, kind = levels[name]
            m = L[name]
            if kind == "up":
                return m(t, op=functools.partial(halo.halo_deconv, mesh=mesh, splits=splits,
                                                 level=lv), stat_sum=stat_sum)
            op = functools.partial(halo.halo_conv, mesh=mesh, splits=splits, level=lv,
                                   replicated=name in IMAGE_LAYERS)
            if isinstance(m, Conv):                    # conv10_2: no norm
                return m(t, op=op)
            return m(t, op=op, stat_sum=stat_sum)

        return self.forward(x, layer)
