"""Depth-map refinement networks (counterpart of
mvsnet_tpu/models/refine.py; reference: cnn_wrapper/mvsnetworks.py:161-325).

* `RefineNet` / `RefineNetConv` ("original"): three 3x3 convs (batch norm /
  plain) and a 1-channel output conv on concat(color image, data); base
  filter 32.
* `RefineUNet` / `RefineUNetConv` ("unet"): a 2D U-Net with four stride-2
  levels and skip concats (group norm / plain); base filter 8.

`data` is the normalised depth, then the probability map with
`refine_with_confidence`, then the stereo view's image with
`refine_with_stereo`; the image comes first in the concat, so the first
conv takes 3 + data channels (`in_channels`). The graphs build the plain
variants (`models/mvsnet.py`); the normed ones are ported with them.
Module names are flax's, so JAX variables load through `convert.py`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mvsnet_tpu_torch.config import scaled_filters
from mvsnet_tpu_torch.models.layers import Conv, ConvBN, ConvGN, Deconv, DeconvGN


def _concat(color_image, data, dtype):
    x = torch.cat([color_image, data], dim=-1)
    return x if dtype is None else x.to(dtype)


class _RefineNetBody(nn.Module):
    """Three 3x3 convs of `b` filters and the 1-channel output conv
    (refine.py:25-58)."""

    use_bn = False

    def __init__(self, in_channels: int, network_mode: str = "normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = scaled_filters(32, network_mode)
        self.dtype = dtype
        for i, cin in enumerate((in_channels, b, b)):
            layer = (ConvBN(cin, b, 3, 1, rank=2, dtype=dtype) if self.use_bn
                     else Conv(cin, b, 3, 1, dtype=dtype))
            self.add_module(f"refine_conv{i}", layer)
        self.refine_conv3 = Conv(b, 1, 3, 1, relu=False, dtype=dtype)

    def forward(self, color_image, data):
        x = _concat(color_image, data, self.dtype)
        for i in range(3):
            x = self._modules[f"refine_conv{i}"](x)
        return self.refine_conv3(x)


class RefineNet(_RefineNetBody):
    use_bn = True


class RefineNetConv(_RefineNetBody):
    use_bn = False


class _RefineUNetBody(nn.Module):
    """The U-Net topology shared by `RefineUNet` (group norms) and
    `RefineUNetConv` (plain) (refine.py:63-130). Four stride-2 levels: the
    input's height and width must divide by 16."""

    use_gn = False

    def __init__(self, in_channels: int, network_mode: str = "normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = scaled_filters(8, network_mode)
        self.dtype = dtype

        def conv(cin, f, s=1):
            return (ConvGN(cin, f, 3, s, dtype=dtype) if self.use_gn
                    else Conv(cin, f, 3, s, dtype=dtype))

        def deconv(cin, f):
            return DeconvGN(cin, f, dtype=dtype) if self.use_gn else Deconv(cin, f, dtype=dtype)

        layers = [
            ("2dconv1_0_refine", conv(in_channels, b * 2, 2)),
            ("2dconv2_0_refine", conv(b * 2, b * 4, 2)),
            ("2dconv3_0_refine", conv(b * 4, b * 8, 2)),
            ("2dconv4_0_refine", conv(b * 8, b * 16, 2)),
            ("2dconv0_1_refine", conv(in_channels, b)),
            ("2dconv0_2_refine", conv(b, b)),
            ("2dconv1_1_refine", conv(b * 2, b * 2)),
            ("2dconv1_2_refine", conv(b * 2, b * 2)),
            ("2dconv2_1_refine", conv(b * 4, b * 4)),
            ("2dconv2_2_refine", conv(b * 4, b * 4)),
            ("2dconv3_1_refine", conv(b * 8, b * 8)),
            ("2dconv3_2_refine", conv(b * 8, b * 8)),
            ("2dconv4_1_refine", conv(b * 16, b * 16)),
            ("2dconv4_2_refine", conv(b * 16, b * 16)),
            ("2dconv5_0_refine", deconv(b * 16, b * 8)),
            ("2dconv5_1_refine", conv(b * 16, b * 8)),
            ("2dconv5_2_refine", conv(b * 8, b * 8)),
            ("2dconv6_0_refine", deconv(b * 8, b * 4)),
            ("2dconv6_1_refine", conv(b * 8, b * 4)),
            ("2dconv6_2_refine", conv(b * 4, b * 4)),
            ("2dconv7_0_refine", deconv(b * 4, b * 2)),
            ("2dconv7_1_refine", conv(b * 4, b * 2)),
            ("2dconv7_2_refine", conv(b * 2, b * 2)),
            ("2dconv8_0_refine", deconv(b * 2, b)),
            ("2dconv8_1_refine", conv(b * 2, b)),
            ("2dconv8_2_refine", conv(b, b)),
            ("2dconv8_3_refine", conv(b, b * 4)),
            ("2dconv8_4_refine", Conv(b * 4, 1, 3, 1, relu=False, dtype=dtype)),
        ]
        for name, module in layers:
            self.add_module(name, module)

    def forward(self, color_image, data):
        L = {k[len("2dconv"):-len("_refine")]: m for k, m in self._modules.items()}
        x = _concat(color_image, data, self.dtype)
        c1_0 = L["1_0"](x)
        c2_0 = L["2_0"](c1_0)
        c3_0 = L["3_0"](c2_0)
        c4_0 = L["4_0"](c3_0)
        c0_2 = L["0_2"](L["0_1"](x))
        c1_2 = L["1_2"](L["1_1"](c1_0))
        c2_2 = L["2_2"](L["2_1"](c2_0))
        c3_2 = L["3_2"](L["3_1"](c3_0))
        c4_2 = L["4_2"](L["4_1"](c4_0))
        c5_2 = L["5_2"](L["5_1"](torch.cat([L["5_0"](c4_2), c3_2], dim=-1)))
        c6_2 = L["6_2"](L["6_1"](torch.cat([L["6_0"](c5_2), c2_2], dim=-1)))
        c7_2 = L["7_2"](L["7_1"](torch.cat([L["7_0"](c6_2), c1_2], dim=-1)))
        c8_2 = L["8_2"](L["8_1"](torch.cat([L["8_0"](c7_2), c0_2], dim=-1)))
        return L["8_4"](L["8_3"](c8_2))


class RefineUNet(_RefineUNetBody):
    use_gn = True


class RefineUNetConv(_RefineUNetBody):
    use_gn = False
