"""RegNetUS0, the 3D-CNN cost-volume regularizer (counterpart of
mvsnet_tpu/models/regnet.py:30-95).

A 3-level 3D U-Net over (D, H/4, W/4) with additive skips and eval batch
norms folded into the convs, then a 1-channel 3x3x3 conv without bias or
ReLU: (B, D, h, w, C) -> (B, D, h, w, 1).

`forward_sharded` runs the same graph on this rank's depth x space block
of the volume, its convs swapped for the halo-exchanging ones over the
mesh's 'depth' and 'space' axes (`parallel/halo.py`), in eval (the latency
regime of multi-device serving) and in training. `plan_volume` decides
how the volume lies over the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional

import torch
from torch import nn

from mvsnet_tpu_torch.config import scaled_filters
from mvsnet_tpu_torch.models.layers import Conv, ConvBN, DeconvBN
from mvsnet_tpu_torch.parallel.halo import halo_conv, halo_deconv
from mvsnet_tpu_torch.parallel.mesh import AxisSplit, Mesh

logger = logging.getLogger(__name__)

LEVELS = 3   # the U-Net's stride-2 halvings


@dataclasses.dataclass(frozen=True)
class VolumePlan:
    """How a cost volume of D planes and h feature rows lies over a mesh:
    `depth` and `rows` split its planes over 'depth' and its rows over
    'space' (one rank: whole on every rank), as the cost volume is
    computed; the axes in `gathered` are gathered before the U-Net, which
    runs whole along them, and its output is cut back to the block."""

    depth: AxisSplit
    rows: AxisSplit
    gathered: tuple = ()

    def net_split(self, split: AxisSplit) -> AxisSplit:
        """The U-Net's split along that axis."""
        return AxisSplit(split.axis, split.size) if split.axis in self.gathered else split

    @property
    def sharded(self) -> tuple:
        """The mesh axes along which ranks hold different blocks."""
        return tuple(s.axis for s in (self.depth, self.rows) if s.n > 1)


def _axis_plan(mesh: Mesh, axis: str, size: int, what: str):
    n = mesh.axis_size(axis)
    if n == 1:
        return AxisSplit(axis, size), False
    if size % n:
        logger.warning("RegNetUS0: %d %s do not divide over %d %r ranks; every rank "
                       "computes the whole volume along them, as JAX's constrain drops "
                       "the axis", size, what, n, axis)
        return AxisSplit(axis, size), False
    split = AxisSplit(axis, size, n, mesh.axis_index(axis))
    if not split.filled(LEVELS):
        logger.warning("RegNetUS0: %d %s over %d %r ranks leave a rank none at the U-Net's "
                       "level %d; gathering the volume over %r and running the U-Net whole "
                       "along it on every rank", size, what, n, axis, LEVELS, axis)
        return split, True
    return split, False


def plan_volume(mesh: Mesh, D: int, h: int) -> VolumePlan:
    """The blocks of a volume of D planes and h feature rows over the mesh:
    each of 'depth' and 'space' splits its axis evenly, its levels by the
    stride rule (`AxisSplit`), except where the axis does not divide (the
    whole axis on every rank, as JAX's `constrain` drops it) or where a
    level would leave a rank empty (blocks gathered before the U-Net).
    Either case logs a warning."""
    depth, gd = _axis_plan(mesh, "depth", D, "planes")
    rows, gr = _axis_plan(mesh, "space", h, "feature rows")
    return VolumePlan(depth, rows, tuple(a for a, g in (("depth", gd), ("space", gr)) if g))


class RegNetUS0(nn.Module):
    def __init__(self, network_mode: str = "normal", in_channels: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = scaled_filters(8, network_mode)
        self.dtype = dtype
        layers = [
            ("3dconv1_0", ConvBN(in_channels, b * 2, 3, 2, dtype=dtype)),
            ("3dconv2_0", ConvBN(b * 2, b * 4, 3, 2, dtype=dtype)),
            ("3dconv3_0", ConvBN(b * 4, b * 8, 3, 2, dtype=dtype)),
            ("3dconv0_1", ConvBN(in_channels, b, 3, 1, dtype=dtype)),
            ("3dconv1_1", ConvBN(b * 2, b * 2, 3, 1, dtype=dtype)),
            ("3dconv2_1", ConvBN(b * 4, b * 4, 3, 1, dtype=dtype)),
            ("3dconv3_1", ConvBN(b * 8, b * 8, 3, 1, dtype=dtype)),
            ("3dconv4_0", DeconvBN(b * 8, b * 4, dtype=dtype)),
            ("3dconv5_0", DeconvBN(b * 4, b * 2, dtype=dtype)),
            ("3dconv6_0", DeconvBN(b * 2, b, dtype=dtype)),
            ("3dconv6_2", Conv(b, 1, 3, 1, relu=False, use_bias=False, rank=3,
                               dtype=dtype)),
        ]
        for name, module in layers:
            self.add_module(name, module)

    def forward(self, x, ops=None):
        """Eval or training forward of the volume x (B, D, h, w, C).
        `ops(level)`, where given, returns the (conv, deconv) that replace
        the kernels' calls on inputs at that level (see `layers.Conv`);
        `forward_sharded` passes the halo-exchanging ones."""
        L = self._modules
        if self.dtype is not None:
            x = x.to(self.dtype)

        def conv(level):
            return None if ops is None else ops(level)[0]

        def deconv(level):
            return None if ops is None else ops(level)[1]
        c1_0 = L["3dconv1_0"](x, conv(0))
        c2_0 = L["3dconv2_0"](c1_0, conv(1))
        c3_0 = L["3dconv3_0"](c2_0, conv(2))
        c0_1 = L["3dconv0_1"](x, conv(0))
        c1_1 = L["3dconv1_1"](c1_0, conv(1))
        c2_1 = L["3dconv2_1"](c2_0, conv(2))
        c3_1 = L["3dconv3_1"](c3_0, conv(3))
        c4_1 = L["3dconv4_0"](c3_1, deconv(3)) + c2_1
        c5_1 = L["3dconv5_0"](c4_1, deconv(2)) + c1_1
        c6_1 = L["3dconv6_0"](c5_1, deconv(1)) + c0_1
        return L["3dconv6_2"](c6_1, op=conv(0))

    def forward_sharded(self, x, mesh: Mesh, plan: Optional[VolumePlan] = None):
        """Eval or training forward of this rank's block x (B, Dl, hl, w, C)
        of a volume laid out by `plan` (default `plan_volume` of the volume
        whose blocks are even: D = depth * Dl, h = space * hl). Returns its
        block of the output, (B, Dl, hl, w, 1). The blocks of an axis in
        `plan.gathered` are gathered first (differentiably: each rank's
        cotangent comes back summed) and the output is cut back to them."""
        if plan is None:
            plan = plan_volume(mesh, x.shape[1] * mesh.axis_size("depth"),
                               x.shape[2] * mesh.axis_size("space"))
        cut = []
        for dim, split in ((1, plan.depth), (2, plan.rows)):
            if split.axis in plan.gathered:
                x = mesh.all_gather_grad(x, split.axis, dim=dim)
                cut.append((dim, split.bounds(0)))
        splits = (plan.net_split(plan.depth), plan.net_split(plan.rows), None)

        def ops(level):
            return (functools.partial(halo_conv, mesh=mesh, splits=splits, level=level),
                    functools.partial(halo_deconv, mesh=mesh, splits=splits, level=level))
        y = self.forward(x, ops)
        for dim, (a, b) in cut:
            y = y.narrow(dim, a, b - a)
        return y
