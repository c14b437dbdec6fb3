"""RegNetUS0, the 3D-CNN cost-volume regularizer (counterpart of
mvsnet_tpu/models/regnet.py:30-95).

A 3-level 3D U-Net over (D, H/4, W/4) with additive skips and eval batch
norms folded into the convs, then a 1-channel 3x3x3 conv without bias or
ReLU: (B, D, h, w, C) -> (B, D, h, w, 1).

`forward_sharded` runs the same graph on a depth slab of the volume, its
convs swapped for the halo-exchanging ones over the mesh's 'depth' axis
(`parallel/halo.py`): the latency regime of multi-device serving.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

import torch
from torch import nn

from mvsnet_tpu_torch.config import scaled_filters
from mvsnet_tpu_torch.models.layers import Conv, ConvBN, DeconvBN
from mvsnet_tpu_torch.parallel.halo import halo_conv, halo_deconv
from mvsnet_tpu_torch.parallel.mesh import shards

logger = logging.getLogger(__name__)


def depth_sharded(max_d: int, depth: int) -> bool:
    """Whether the U-Net shards its depth over `depth` ranks: the three
    halvings must stay even on every slab, max_d % (8 * depth) == 0
    (at D=192 the deepest slab is 6 planes on 4 ranks)."""
    return shards(max_d, 8 * depth) and depth > 1


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

    def forward(self, x, conv=None, deconv=None):
        """Eval or training forward of the volume x (B, D, h, w, C). In
        eval, `conv` and `deconv` replace the kernels' calls (see
        `layers.Conv`); `forward_sharded` passes the depth-slab versions."""
        L = self._modules
        if self.dtype is not None:
            x = x.to(self.dtype)
        c1_0 = L["3dconv1_0"](x, conv)
        c2_0 = L["3dconv2_0"](c1_0, conv)
        c3_0 = L["3dconv3_0"](c2_0, conv)
        c0_1 = L["3dconv0_1"](x, conv)
        c1_1 = L["3dconv1_1"](c1_0, conv)
        c2_1 = L["3dconv2_1"](c2_0, conv)
        c3_1 = L["3dconv3_1"](c3_0, conv)
        c4_1 = L["3dconv4_0"](c3_1, deconv) + c2_1
        c5_1 = L["3dconv5_0"](c4_1, deconv) + c1_1
        c6_1 = L["3dconv6_0"](c5_1, deconv) + c0_1
        return L["3dconv6_2"](c6_1, op=conv)

    def forward_sharded(self, x, mesh):
        """Eval forward of this rank's depth slab x (B, Dl, h, w, C), the
        planes [r * Dl, (r + 1) * Dl) of a volume of D = depth * Dl planes,
        r the rank's 'depth' index. Returns its slab of the output,
        (B, Dl, h, w, 1). Where `depth_sharded(D, depth)` fails, the slabs
        are gathered and the U-Net runs whole on every rank, as `constrain`
        drops an axis that does not divide."""
        if self.training:
            raise NotImplementedError("the depth-sharded U-Net is inference only")
        n, r = mesh.axis_size("depth"), mesh.axis_index("depth")
        Dl = x.shape[1]
        if not depth_sharded(n * Dl, n):
            if n > 1:
                logger.warning("RegNetUS0: D=%d does not split into %d even slabs of "
                               "3 halvings; gathering the volume and running the "
                               "U-Net whole on every rank", n * Dl, n)
            whole = self.forward(mesh.all_gather(x.contiguous(), "depth", dim=1))
            return whole[:, r * Dl:(r + 1) * Dl]
        return self.forward(x, functools.partial(halo_conv, mesh=mesh),
                            functools.partial(halo_deconv, mesh=mesh))
