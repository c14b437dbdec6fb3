"""Layer primitives (counterpart of mvsnet_tpu/models/layers.py: `Conv`,
`Deconv`, `group_norm_core`, `GroupNormRef`, `BatchNormRef`, `ConvGN`,
`DeconvGN`, `ConvBN`, `DeconvBN`, `_fold_affine` and `_bn_affine_probe`).

Parameters are float32 and keep flax's names and layouts: conv kernels are
HWIO/DHWIO, transposed-conv kernels flax-oriented, group and batch norms
carry `scale` and `bias`, batch norms their running `mean` and `var`. Every
conv and transposed conv runs through the port's kernels (`ops/kernels`).

The mode follows `nn.Module.training`. In eval, batch norms fold into the
conv (kernel * scale in float32 before the cast to the compute dtype; shift
and ReLU on the float32 sums in the kernel's epilogue). In training, convs
run unfused through their autograd functions (`ops/autograd.py`) and batch
norms normalise with the batch's statistics in float32 and update their
running statistics, as flax's `BatchNorm` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mvsnet_tpu_torch.ops import autograd
from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import deconv as deconv_k


def fold_affine(kernel, bias, post_scale, post_shift):
    """Fold a per-channel affine applied after the conv (an eval batch norm)
    into the kernel and one shift (layers.py:90-101)."""
    k, shift = kernel, bias
    if post_scale is not None:
        k = kernel * post_scale
        if shift is not None:
            shift = shift * post_scale
    if post_shift is not None:
        shift = post_shift if shift is None else shift + post_shift
    return k, shift


class _ConvBase(nn.Module):
    def __init__(self, kernel_shape, filters: int, relu: bool, use_bias: bool,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_shape, dtype=torch.float32))
        self.bias = (nn.Parameter(torch.zeros(filters, dtype=torch.float32))
                     if use_bias else None)
        self.relu = relu
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Lecun-normal kernel (std 1/sqrt(fan_in)), zero bias."""
        fan_in = math.prod(self.kernel.shape[:-1])
        with torch.no_grad():
            self.kernel.copy_(torch.randn(self.kernel.shape, generator=generator)
                              / math.sqrt(fan_in))
            if self.bias is not None:
                self.bias.zero_()

    def _operands(self, x, post_scale, post_shift):
        k, shift = fold_affine(self.kernel, self.bias, post_scale, post_shift)
        dtype = self.dtype or x.dtype
        return x.to(dtype), k.to(dtype), shift

    def _train_forward(self, fn, x):
        """Unfused, differentiable: conv in the compute dtype, then bias
        and ReLU in the output's dtype (layers.py:426-434)."""
        dtype = self.dtype or x.dtype
        y = fn(x.to(dtype), self.kernel.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return torch.relu(y) if self.relu else y


class Conv(_ConvBase):
    """SAME conv of rank 2 or 3 (layers.py:476-574), on the conv kernel.

    `post_scale`, `post_shift` and `post_relu` apply a per-channel affine
    and a ReLU after the conv, folded into the kernel and its epilogue."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, use_bias: bool = True,
                 rank: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__((kernel,) * rank + (in_channels, filters), filters,
                         relu, use_bias, dtype)
        self.stride = stride

    def forward(self, x, post_scale=None, post_shift=None, post_relu: bool = False):
        if self.training:
            return self._train_forward(
                lambda a, k: autograd.ConvFn.apply(a, k, self.stride), x)
        x, k, shift = self._operands(x, post_scale, post_shift)
        return conv_k.conv(x, k, shift, self.stride, relu=post_relu or self.relu)


class Deconv(_ConvBase):
    """k3 s2 SAME transposed conv of rank 2 or 3 (layers.py:688-766), on the
    transposed-conv kernel; `post_*` as for `Conv`."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 2, relu: bool = True, use_bias: bool = True,
                 rank: int = 2, dtype: Optional[torch.dtype] = None):
        if (kernel, stride) != (3, 2):
            raise NotImplementedError("the port's transposed conv is k3 s2 only")
        super().__init__((3,) * rank + (in_channels, filters), filters, relu,
                         use_bias, dtype)

    def forward(self, x, post_scale=None, post_shift=None, post_relu: bool = False):
        if self.training:
            return self._train_forward(autograd.DeconvFn.apply, x)
        x, k, shift = self._operands(x, post_scale, post_shift)
        return deconv_k.deconv(x, k, shift, relu=post_relu or self.relu)


def group_norm_core(x, gamma, beta, num_groups: int, eps: float):
    """Group norm of channels-last x (N, ..., C) in float32, cast back
    (layers.py:769-811): channel c is in group c // (C // G); moments are
    two-pass, per channel over the spatial axes first, then per group."""
    N, C = x.shape[0], x.shape[-1]
    G = num_groups
    spatial = tuple(range(1, x.ndim - 1))
    bshape = (N,) + (1,) * (x.ndim - 2) + (C,)
    xf = x.to(torch.float32)

    def group_mean(per_channel):                      # (N, C) -> (N, C)
        g = per_channel.reshape(N, G, C // G).mean(dim=2, keepdim=True)
        return g.expand(N, G, C // G).reshape(N, C)

    mean = group_mean(xf.mean(dim=spatial)).reshape(bshape)
    var = group_mean(torch.square(xf - mean).mean(dim=spatial)).reshape(bshape)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x.dtype)


class GroupNormRef(nn.Module):
    """Groups of `group_channel` channels, eps 1e-5 (layers.py:814-832)."""

    def __init__(self, channels: int, group_channel: int = 8, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))
        self.groups = max(1, channels // group_channel)
        self.eps = eps

    def forward(self, x):
        return group_norm_core(x, self.scale, self.bias, self.groups, self.eps)


class BatchNormRef(nn.Module):
    """Batch norm with running statistics, momentum 0.99, eps 1e-5, float32
    output (layers.py:878-902, flax `BatchNorm`)."""

    momentum = 0.99

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))
        self.register_buffer("mean", torch.zeros(channels, dtype=torch.float32))
        self.register_buffer("var", torch.ones(channels, dtype=torch.float32))
        self.eps = eps

    def forward(self, x):
        """Normalise channels-last x over every axis but the last, in
        float32. Training uses the batch's mean and biased variance
        max(0, E[x^2] - E[x]^2) (flax `_compute_stats`) and moves the
        running statistics to momentum * running + (1 - momentum) * batch,
        without gradient; eval uses the running statistics."""
        x32 = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x32.mean(dim=axes)
            var = torch.clamp_min((x32 * x32).mean(dim=axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias

    def affine(self):
        """(scale, shift) with bn(x) = x * scale + shift, probed as bn(1) -
        bn(0) and bn(0) in flax's operation order (layers.py:1005-1013)."""
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        shift = (0.0 - self.mean) * mul + self.bias
        return ((1.0 - self.mean) * mul + self.bias) - shift, shift


class ConvGN(nn.Module):
    """conv (no bias) -> group norm -> ReLU (layers.py:954-977)."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, rank: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(in_channels, filters, kernel, stride, relu=False,
                         use_bias=False, rank=rank, dtype=dtype)
        self.gn = GroupNormRef(filters)
        self.relu = relu

    def forward(self, x):
        y = self.gn(self.conv(x))
        return torch.relu(y) if self.relu else y


class DeconvGN(nn.Module):
    """deconv (no bias) -> group norm [-> ReLU, off by default]
    (layers.py:980-1002)."""

    def __init__(self, in_channels: int, filters: int, relu: bool = False,
                 rank: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deconv = Deconv(in_channels, filters, relu=False, use_bias=False,
                             rank=rank, dtype=dtype)
        self.gn = GroupNormRef(filters)
        self.relu = relu

    def forward(self, x):
        y = self.gn(self.deconv(x))
        return torch.relu(y) if self.relu else y


class ConvBN(nn.Module):
    """conv (no bias) -> batch norm -> ReLU (layers.py:1016-1049); in eval
    the norm is folded into the conv."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, rank: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(in_channels, filters, kernel, stride, relu=False,
                         use_bias=False, rank=rank, dtype=dtype)
        self.bn = BatchNormRef(filters)
        self.relu = relu

    def forward(self, x):
        if self.training:
            y = self.bn(self.conv(x))
            return torch.relu(y) if self.relu else y
        scale, shift = self.bn.affine()
        return self.conv(x, post_scale=scale, post_shift=shift, post_relu=self.relu)


class DeconvBN(nn.Module):
    """deconv (no bias) -> batch norm -> ReLU (layers.py:1052-1078); in
    eval the norm is folded into the deconv."""

    def __init__(self, in_channels: int, filters: int, relu: bool = True,
                 rank: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deconv = Deconv(in_channels, filters, relu=False, use_bias=False,
                             rank=rank, dtype=dtype)
        self.bn = BatchNormRef(filters)
        self.relu = relu

    def forward(self, x):
        if self.training:
            y = self.bn(self.deconv(x))
            return torch.relu(y) if self.relu else y
        scale, shift = self.bn.affine()
        return self.deconv(x, post_scale=scale, post_shift=shift,
                           post_relu=self.relu)


def reset_parameters(module: nn.Module, seed: int) -> None:
    """Seeded init of every conv and transposed-conv kernel in `module`, in
    module order; norms keep their identity init."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, _ConvBase):
            m.reset_parameters(g)
