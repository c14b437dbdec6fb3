"""2D feature towers (counterpart of mvsnet_tpu/models/feature_net.py).

  * UNetDS2GN, the production tower every graph uses: a 2D U-Net (4
    stride-2 levels, skip concats on the channel axis, group norms) then
    two stride-2 group-norm conv blocks: (B, H, W, 3) -> (B, H/4, W/4,
    4 * base) in the compute dtype, base = max(1, int(8 / div)).
  * UniNetDS2 / UniNetDS2GN, the reference's simpler 8-layer towers with
    batch or group norm (mvsnetworks.py:17-50): exported, no graph builds
    them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mvsnet_tpu_torch.config import scaled_filters
from mvsnet_tpu_torch.models.layers import Conv, ConvBN, ConvGN, DeconvGN


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

    def forward(self, x):
        L = self._modules
        if self.dtype is not None:
            x = x.to(self.dtype)
        c1_0 = L["2dconv1_0"](x)
        c2_0 = L["2dconv2_0"](c1_0)
        c3_0 = L["2dconv3_0"](c2_0)
        c4_0 = L["2dconv4_0"](c3_0)
        c0_2 = L["2dconv0_2"](L["2dconv0_1"](x))
        c1_2 = L["2dconv1_2"](L["2dconv1_1"](c1_0))
        c2_2 = L["2dconv2_2"](L["2dconv2_1"](c2_0))
        c3_2 = L["2dconv3_2"](L["2dconv3_1"](c3_0))
        c4_2 = L["2dconv4_2"](L["2dconv4_1"](c4_0))
        c5_0 = L["2dconv5_0"](c4_2)
        c5_2 = L["2dconv5_2"](L["2dconv5_1"](torch.cat([c5_0, c3_2], dim=-1)))
        c6_0 = L["2dconv6_0"](c5_2)
        c6_2 = L["2dconv6_2"](L["2dconv6_1"](torch.cat([c6_0, c2_2], dim=-1)))
        c7_0 = L["2dconv7_0"](c6_2)
        c7_2 = L["2dconv7_2"](L["2dconv7_1"](torch.cat([c7_0, c1_2], dim=-1)))
        c8_0 = L["2dconv8_0"](c7_2)
        c8_2 = L["2dconv8_2"](L["2dconv8_1"](torch.cat([c8_0, c0_2], dim=-1)))
        c9_2 = L["conv9_2"](L["conv9_1"](L["conv9_0"](c8_2)))
        c10_1 = L["conv10_1"](L["conv10_0"](c9_2))
        return L["conv10_2"](c10_1)
