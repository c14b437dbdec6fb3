"""CasMVSNet (Gu et al., "Cascade Cost Volume for High-Resolution
Multi-View Stereo and Stereo Matching", CVPR 2020, arXiv:1912.06378; the
official alibaba/cascade-stereo, CasMVSNet/models/{cas_mvsnet.py,
module.py}): an FPN feature tower, then a cascade of stages from a quarter
of the images' resolution to the whole, each a variance cost volume over
its own depth planes, its own CostRegNet 3D U-Net and a softmax
regression. The JAX package has no cascade: this graph is the port's own.

Channels-last tensors; parameters float32 in the layouts of
`models/layers.py`, eval batch norms folded into the convs' kernels and
epilogues. The published model pads as PyTorch does, k // 2 on every side
(a stride-2 conv's low pad is 1 or 2 where TF's "SAME" is 0 or 1), and
upsamples with `ConvTranspose3d(k3, s2, padding 1, output_padding 1)`:
the kernels take both (`pads`, `lo`), so every conv of the graph runs on
the port's conv kernels. Each stage's cost volume runs on the per-pixel
edition of K1 (`ops/kernels/sweep.pixel_cost_volume`).

While a profiler records, the forward runs inside `utils.profiling.span`
ranges: `mvsnet.features` (the tower), and per stage `mvsnet.cascade.stage`
(id `stage`) around `mvsnet.cascade.planes` (the stage's plane depths),
`mvsnet.cost_volume` (its projections and volume), `mvsnet.regularizer`
(its U-Net) and `mvsnet.depth_tail` (the regression). It counts
`cascade.stages` and `cascade.planes`, the pixel-planes formed.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from mvsnet_tpu_torch.config import ModelConfig, scaled_filters
from mvsnet_tpu_torch.models.layers import Conv, ConvBN, DeconvBN, reset_parameters
from mvsnet_tpu_torch.ops.cost_volume import pixel_cost_volume
from mvsnet_tpu_torch.ops.depth import cascade_regression
from mvsnet_tpu_torch.ops.geometry import cascade_planes, pixel_projections
from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import deconv as deconv_k
from mvsnet_tpu_torch.utils.profiling import count, span

# the published stages (DTU's setting): depth planes and plane interval, in
# depth intervals, from a quarter of the images' resolution to the whole
PLANES = (48, 32, 8)
INTERVAL_RATIOS = (4, 2, 1)


def _conv_padded(x, kernel, shift, stride, relu, pads):
    return conv_k.conv(x, kernel, shift, stride, relu, pads=pads)


def _deconv_lo1(x, kernel, shift, relu):
    return deconv_k.deconv(x, kernel, shift, relu, lo=1)


class ConvBNTorch(ConvBN):
    """conv (no bias) -> batch norm -> ReLU with PyTorch's padding, k // 2
    on every side of every spatial axis (eval)."""

    def forward(self, x):
        k = self.conv.kernel
        pads = ((k.shape[0] // 2,) * 2,) * (k.ndim - 2)
        return super().forward(x, op=functools.partial(_conv_padded, pads=pads))


class DeconvBNTorch(DeconvBN):
    """`ConvTranspose3d(k3, s2, padding 1, output_padding 1)` -> batch norm
    -> ReLU (eval): output 2n per axis, out[2i + t - 1] takes the
    flax-oriented kernel's k[2 - t] x[i]."""

    def forward(self, x):
        return super().forward(x, op=_deconv_lo1)


class FPN(nn.Module):
    """The cascade's feature tower (`FeatureNet`, arch_mode "fpn"): images
    (N, H, W, 3) -> the features of stages 1, 2, 3, (N, H/4, W/4, 4b),
    (N, H/2, W/2, 2b), (N, H, W, b). Three levels of conv -> batch norm ->
    ReLU (the first conv of levels 1 and 2 5x5 stride 2), a 1x1 conv of
    the coarsest level, and two steps up: the level above upsampled by
    nearest neighbour plus a 1x1 lateral (with bias) of the finer level,
    then a 3x3 conv to the stage's channels."""

    def __init__(self, network_mode: str = "normal", dtype=None):
        super().__init__()
        b = scaled_filters(8, network_mode)
        layers = [("conv0_0", 3, b, 3, 1), ("conv0_1", b, b, 3, 1),
                  ("conv1_0", b, 2 * b, 5, 2), ("conv1_1", 2 * b, 2 * b, 3, 1),
                  ("conv1_2", 2 * b, 2 * b, 3, 1),
                  ("conv2_0", 2 * b, 4 * b, 5, 2), ("conv2_1", 4 * b, 4 * b, 3, 1),
                  ("conv2_2", 4 * b, 4 * b, 3, 1)]
        for name, cin, cout, k, stride in layers:
            self.add_module(name, ConvBNTorch(cin, cout, k, stride, rank=2, dtype=dtype))
        heads = [("out1", 4 * b, 4 * b, 1, False), ("inner1", 2 * b, 4 * b, 1, True),
                 ("inner2", b, 4 * b, 1, True), ("out2", 4 * b, 2 * b, 3, False),
                 ("out3", 4 * b, b, 3, False)]
        for name, cin, cout, k, bias in heads:
            self.add_module(name, Conv(cin, cout, k, relu=False, use_bias=bias, dtype=dtype))
        self.dtype = dtype
        self.channels = (4 * b, 2 * b, b)

    def forward(self, x):
        L = self._modules
        if self.dtype is not None:
            x = x.to(self.dtype)
        c0 = L["conv0_1"](L["conv0_0"](x))
        c1 = L["conv1_2"](L["conv1_1"](L["conv1_0"](c0)))
        c2 = L["conv2_2"](L["conv2_1"](L["conv2_0"](c1)))
        t = up2_add(c2, L["inner1"](c1))
        f2 = L["out2"](t)
        t = up2_add(t, L["inner2"](c0))
        return L["out1"](c2), f2, L["out3"](t)


def up2_add(coarse, fine):
    """coarse (N, h, w, C) upsampled x2 by nearest neighbour, plus fine
    (N, 2h, 2w, C), without the upsampled copy."""
    N, h, w, C = coarse.shape
    out = fine.reshape(N, h, 2, w, 2, C) + coarse[:, :, None, :, None]
    return out.reshape(N, 2 * h, 2 * w, C)


class CostRegNet(nn.Module):
    """One stage's 3D U-Net (module.py's `CostRegNet`): (B, D, h, w, Cin) ->
    the cost (B, D, h, w, 1). Each level a stride-2 conv and a conv; the
    way up adds each transposed conv's output to the level's conv; a bare
    3x3x3 conv to one channel last."""

    def __init__(self, in_channels: int, base: int, dtype=None):
        super().__init__()
        b = base
        for name, cin, cout, stride in (("conv0", in_channels, b, 1), ("conv1", b, 2 * b, 2),
                                        ("conv2", 2 * b, 2 * b, 1), ("conv3", 2 * b, 4 * b, 2),
                                        ("conv4", 4 * b, 4 * b, 1), ("conv5", 4 * b, 8 * b, 2),
                                        ("conv6", 8 * b, 8 * b, 1)):
            self.add_module(name, ConvBNTorch(cin, cout, 3, stride, rank=3, dtype=dtype))
        for name, cin, cout in (("conv7", 8 * b, 4 * b), ("conv9", 4 * b, 2 * b),
                                ("conv11", 2 * b, b)):
            self.add_module(name, DeconvBNTorch(cin, cout, dtype=dtype))
        self.prob = Conv(b, 1, 3, relu=False, use_bias=False, rank=3, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        L = self._modules
        if self.dtype is not None:
            x = x.to(self.dtype)
        x0 = L["conv0"](x)
        x2 = L["conv2"](L["conv1"](x0))
        x4 = L["conv4"](L["conv3"](x2))
        y = L["conv6"](L["conv5"](x4))
        y = x4 + L["conv7"](y)
        y = x2 + L["conv9"](y)
        y = x0 + L["conv11"](y)
        return self.prob(y)


class CascadeRegNet(nn.Module):
    """The stages' U-Nets, not shared (`stages[s]` takes the stage's feature
    channels), behind one module that is called once a stage."""

    def __init__(self, channels, base: int, dtype=None):
        super().__init__()
        self.stages = nn.ModuleList(CostRegNet(c, base, dtype) for c in channels)

    def forward(self, volume, stage: int):
        return self.stages[stage](volume)


class CasMVSNet(nn.Module):
    """The tower (`feature_net`) and the stages' U-Nets (`regnet`), eval,
    selected by `cfg.cascade`. The stages (`PLANES`, `INTERVAL_RATIOS`) run
    from a quarter of the images' resolution, doubling, to the whole.
    Weights are seeded with `seed` (lecun-normal kernels, identity norms)
    until a state dict is loaded."""

    # `serve`'s maps are the last stage's, at the images' resolution
    maps_at_image_resolution = True

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        if not cfg.cascade or cfg.regularization != "3DCNN":
            raise ValueError("CasMVSNet needs cfg.cascade and its 3D U-Nets (regularization "
                             f"'3DCNN'), got {cfg.cascade}, {cfg.regularization!r}")
        self.cfg = cfg
        self.feature_net = FPN(cfg.network_mode, dtype=cfg.dtype)
        channels = self.feature_net.channels
        self.regnet = CascadeRegNet(channels, scaled_filters(8, cfg.network_mode), cfg.dtype)
        reset_parameters(self, seed)
        self.eval()

    def check_shape(self, H: int, W: int) -> None:
        """Each U-Net halves its volume three times: (D_s, h_s, w_s) % 8 == 0
        at every stage, so the images' H and W divide by 8 times the first
        stage's downscale (32 for three stages)."""
        unit = 8 * 2 ** (len(PLANES) - 1)
        if H % unit or W % unit:
            raise ValueError(f"images of {H}x{W} (height x width): the U-Nets need H and W "
                             f"divisible by {unit}")

    def forward(self, images, cams, depth_start, depth_interval):
        """images (B, V, H, W, 3), view 0 the reference; cams (B, V, 2, 4, 4)
        scaled to a quarter of the images (the first stage's resolution);
        depth_start, depth_interval (B,), with depth_max = depth_start +
        (max_d - 1) depth_interval. Returns the last stage's depth and
        confidence, each (B, H, W, 1) float32."""
        cfg = self.cfg
        B, V, H, W, _ = images.shape
        self.check_shape(H, W)
        ds = torch.as_tensor(depth_start, dtype=torch.float32, device=images.device).expand(B)
        di = torch.as_tensor(depth_interval, dtype=torch.float32, device=images.device).expand(B)
        de = ds + (cfg.max_d - 1) * di
        with span("mvsnet.features"):
            feats = self.feature_net(images.reshape(B * V, H, W, 3))
        depth = None
        for s, (num, ratio) in enumerate(zip(PLANES, INTERVAL_RATIOS)):
            with span("mvsnet.cascade.stage", stage=s):
                f = feats[s]
                h, w, C = f.shape[1:]
                f = f.reshape(B, V, h, w, C)
                with span("mvsnet.cascade.planes"):
                    planes = cascade_planes(depth, num, ratio, ds, de, cfg.max_d, (h, w))
                count("cascade.stages")
                count("cascade.planes", B * num * h * w)
                with span("mvsnet.cost_volume"):
                    proj = pixel_projections(cams, 2.0 ** s)
                    volume = pixel_cost_volume(f[:, 0], f[:, 1:].movedim(1, 0), planes, proj)
                with span("mvsnet.regularizer"):
                    cost = self.regnet(volume, s)
                with span("mvsnet.depth_tail"):
                    depth, conf = cascade_regression(cost[..., 0], planes)
        return depth[..., None], conf[..., None]

    def serve(self, images, cams, depth_start, depth_interval, depth_end):
        """The serving call (`Predictor.predict`): the depth and confidence
        of `forward`, which reads `depth_interval` and not `depth_end`, and
        a zero residual; each (B, H, W, 1) float32."""
        depth, conf = self(images, cams, depth_start, depth_interval)
        return depth, conf, torch.zeros_like(depth)
