"""RegNetUS0, the 3D-CNN cost-volume regularizer (counterpart of
mvsnet_tpu/models/regnet.py:30-95).

A 3-level 3D U-Net over (D, H/4, W/4) with additive skips and eval batch
norms folded into the convs, then a 1-channel 3x3x3 conv without bias or
ReLU: (B, D, h, w, C) -> (B, D, h, w, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mvsnet_tpu_torch.config import scaled_filters
from mvsnet_tpu_torch.models.layers import Conv, ConvBN, DeconvBN


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

    def forward(self, x):
        L = self._modules
        if self.dtype is not None:
            x = x.to(self.dtype)
        c1_0 = L["3dconv1_0"](x)
        c2_0 = L["3dconv2_0"](c1_0)
        c3_0 = L["3dconv3_0"](c2_0)
        c0_1 = L["3dconv0_1"](x)
        c1_1 = L["3dconv1_1"](c1_0)
        c2_1 = L["3dconv2_1"](c2_0)
        c3_1 = L["3dconv3_1"](c3_0)
        c4_1 = L["3dconv4_0"](c3_1) + c2_1
        c5_1 = L["3dconv5_0"](c4_1) + c1_1
        c6_1 = L["3dconv6_0"](c5_1) + c0_1
        return L["3dconv6_2"](c6_1)
