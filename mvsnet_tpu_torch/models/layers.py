"""Layer primitives (counterpart of mvsnet_tpu/models/layers.py: `Conv`,
`Deconv`, `group_norm_core`, `GroupNormRef`, `GroupNormFlexible`,
`BatchNormRef`, `ConvGN`, `DeconvGN`, `ConvBN`, `DeconvBN`, `_fold_affine`
and `_bn_affine_probe`, and the reference's `network.py` extras `Fc`,
`Dropout`, `max_pool`, `avg_pool` and `l2_pool`, which no graph uses).

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

import torch.nn.functional as F

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
    and a ReLU after the conv, folded into the kernel and its epilogue.
    `op` replaces the kernel's call `conv(x, kernel, shift, stride, relu)`,
    for example with the block version (`parallel/halo.py`); in training it
    is called without shift or ReLU and must be differentiable."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, use_bias: bool = True,
                 rank: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__((kernel,) * rank + (in_channels, filters), filters,
                         relu, use_bias, dtype)
        self.stride = stride

    def forward(self, x, post_scale=None, post_shift=None, post_relu: bool = False,
                op=None):
        if self.training:
            if op is not None:
                return self._train_forward(lambda a, k: op(a, k, None, self.stride, False), x)
            return self._train_forward(
                lambda a, k: autograd.ConvFn.apply(a, k, self.stride), x)
        x, k, shift = self._operands(x, post_scale, post_shift)
        return (op or conv_k.conv)(x, k, shift, self.stride, relu=post_relu or self.relu)


class Deconv(_ConvBase):
    """k3 s2 SAME transposed conv of rank 2 or 3 (layers.py:688-766), on the
    transposed-conv kernel; `post_*` and `op` (for `deconv(x, kernel,
    shift, relu)`) as for `Conv`."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 2, relu: bool = True, use_bias: bool = True,
                 rank: int = 2, dtype: Optional[torch.dtype] = None):
        if (kernel, stride) != (3, 2):
            raise NotImplementedError("the port's transposed conv is k3 s2 only")
        super().__init__((3,) * rank + (in_channels, filters), filters, relu,
                         use_bias, dtype)

    def forward(self, x, post_scale=None, post_shift=None, post_relu: bool = False,
                op=None):
        if self.training:
            if op is not None:
                return self._train_forward(lambda a, k: op(a, k, None, False), x)
            return self._train_forward(autograd.DeconvFn.apply, x)
        x, k, shift = self._operands(x, post_scale, post_shift)
        return (op or deconv_k.deconv)(x, k, shift, relu=post_relu or self.relu)


def spatial_mean(t, axes, stat_sum=None, keepdim=False):
    """t's mean over `axes`; with `stat_sum` (a differentiable sum over the
    ranks that hold the rest of the map's rows) the mean over the whole
    map: the local sums and count summed over them, then divided."""
    if stat_sum is None:
        return t.mean(dim=axes, keepdim=keepdim)
    s = t.sum(dim=axes, keepdim=keepdim)
    count = math.prod(t.shape[a] for a in axes)
    total = stat_sum(torch.cat([s.reshape(-1), s.new_full((1,), count)]))
    return total[:-1].reshape(s.shape) / total[-1]


def group_norm_core(x, gamma, beta, num_groups: int, eps: float, stat_sum=None):
    """Group norm of channels-last x (N, ..., C) in float32, cast back
    (layers.py:769-811): channel c is in group c // (C // G). In float32
    the moments are two-pass, per channel over the spatial axes first,
    then per group, as JAX's; `stat_sum`: see `spatial_mean` (two sums).
    A bfloat16 or float16 x takes them from the float64 sums of x and x^2
    (exact: such a value's square is exact in float32, and float64 holds
    these sums to its rounding), mean = S / n and var = Q / n - mean^2 per
    group: sums whose order does not show in float32, so a block of rows
    whose sums `stat_sum` adds up (one sum) gets the whole map's statistics
    bit for bit, as a half-precision request on one card does."""
    N, C = x.shape[0], x.shape[-1]
    G = num_groups
    spatial = tuple(range(1, x.ndim - 1))
    bshape = (N,) + (1,) * (x.ndim - 2) + (C,)
    xf = x.to(torch.float32)

    if x.dtype in (torch.bfloat16, torch.float16):
        sums = torch.stack([xf.sum(dim=spatial, dtype=torch.float64),
                            (xf * xf).sum(dim=spatial, dtype=torch.float64)])   # (2, N, C)
        n = math.prod(x.shape[a] for a in spatial)
        if stat_sum is not None:                      # the count made on the device: no sync
            total = stat_sum(torch.cat([sums.reshape(-1), sums.new_full((1,), n)]))
            sums, n = total[:-1].reshape(sums.shape), total[-1:]
        group = sums.reshape(2, N, G, C // G).sum(dim=3) / (n * (C // G))      # (2, N, G)
        moments = torch.stack([group[0], group[1] - group[0] * group[0]]).to(torch.float32)
        mean, var = (m[:, :, None].expand(N, G, C // G).reshape(bshape) for m in moments)
    else:
        def group_mean(per_channel):                      # (N, C) -> (N, C)
            g = per_channel.reshape(N, G, C // G).mean(dim=2, keepdim=True)
            return g.expand(N, G, C // G).reshape(N, C)

        mean = group_mean(spatial_mean(xf, spatial, stat_sum)).reshape(bshape)
        var = group_mean(spatial_mean(torch.square(xf - mean), spatial,
                                      stat_sum)).reshape(bshape)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x.dtype)


class GroupNormRef(nn.Module):
    """Groups of `group_channel` channels, eps 1e-5 (layers.py:814-832).
    `stat_sum`: x is a block of the map's rows (`group_norm_core`)."""

    def __init__(self, channels: int, group_channel: int = 8, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))
        self.groups = max(1, channels // group_channel)
        self.eps = eps

    def forward(self, x, stat_sum=None):
        return group_norm_core(x, self.scale, self.bias, self.groups, self.eps, stat_sum)


class GroupNormFlexible(nn.Module):
    """The ConvGRU's group norm with its fallbacks (layers.py:835-875):
    G = max(1, C // group_channel) (or min(group, C) when not channel-wise)
      G == 1 -> a layer norm over every non-batch axis, eps 1e-12;
      G >= C -> an instance norm (per channel over the spatial axes), eps 1e-6;
      else   -> `group_norm_core`, eps 1e-5.
    Statistics in float32, two-pass (the variance is mean((x - mean)^2), as
    `jnp.var` computes it), the result cast back to x's dtype. With
    `stat_sum` (the ConvGRU's rows split over 'space') each pass sums its
    statistics over the map's row blocks (`spatial_mean`)."""

    def __init__(self, channels: int, group_channel: int = 16, channel_wise: bool = True,
                 group: int = 32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))
        self.groups = (max(1, channels // group_channel) if channel_wise
                       else min(group, channels))

    def forward(self, x, stat_sum=None):
        C = x.shape[-1]
        if self.groups == 1 or self.groups >= C:
            eps = 1e-12 if self.groups == 1 else 1e-6
            axes = tuple(range(1, x.ndim) if self.groups == 1 else range(1, x.ndim - 1))
            centered = x.to(torch.float32)
            centered = centered - spatial_mean(centered, axes, stat_sum, keepdim=True)
            var = spatial_mean(torch.square(centered), axes, stat_sum, keepdim=True)
            y = centered / torch.sqrt(var + eps) * self.scale + self.bias
            return y.to(x.dtype)
        return group_norm_core(x, self.scale, self.bias, self.groups, 1e-5, stat_sum)


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
        # With the batch sharded over ranks, set for the length of a step
        # only (`parallel.train_step.global_batch_norms`): a differentiable
        # sum over the ranks that hold the rest of it, so the statistics
        # are the global batch's, as flax's under GSPMD.
        self.batch_sum = None

    def _batch_stats(self, x32):
        """Mean and E[x^2] - mean^2 per channel over the (global) batch."""
        axes = tuple(range(x32.ndim - 1))
        C = x32.shape[-1]
        sums = torch.cat([x32.sum(dim=axes), (x32 * x32).sum(dim=axes),
                          x32.new_tensor([x32.numel() // C])])
        if self.batch_sum is not None:
            sums = self.batch_sum(sums)
        mean = sums[:C] / sums[-1]
        return mean, sums[C:2 * C] / sums[-1] - mean * mean

    def forward(self, x):
        """Normalise channels-last x over every axis but the last, in
        float32. Training uses the batch's mean and biased variance
        max(0, E[x^2] - E[x]^2) (flax `_compute_stats`) and moves the
        running statistics to momentum * running + (1 - momentum) * batch,
        without gradient; eval uses the running statistics."""
        x32 = x.to(torch.float32)
        if self.training:
            mean, var = self._batch_stats(x32)
            var = torch.clamp_min(var, 0.0)
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
    """conv (no bias) -> group norm -> ReLU (layers.py:954-977). On a block
    of rows, `op` replaces the conv's kernel call (`Conv`) and `stat_sum`
    sums the norm's statistics over the blocks (`group_norm_core`)."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, rank: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(in_channels, filters, kernel, stride, relu=False,
                         use_bias=False, rank=rank, dtype=dtype)
        self.gn = GroupNormRef(filters)
        self.relu = relu

    def forward(self, x, op=None, stat_sum=None):
        y = self.gn(self.conv(x, op=op), stat_sum)
        return torch.relu(y) if self.relu else y


class DeconvGN(nn.Module):
    """deconv (no bias) -> group norm [-> ReLU, off by default]
    (layers.py:980-1002); `op` and `stat_sum` as for `ConvGN`."""

    def __init__(self, in_channels: int, filters: int, relu: bool = False,
                 rank: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deconv = Deconv(in_channels, filters, relu=False, use_bias=False,
                             rank=rank, dtype=dtype)
        self.gn = GroupNormRef(filters)
        self.relu = relu

    def forward(self, x, op=None, stat_sum=None):
        y = self.gn(self.deconv(x, op=op), stat_sum)
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

    def forward(self, x, op=None):
        if self.training:
            y = self.bn(self.conv(x, op=op))
            return torch.relu(y) if self.relu else y
        scale, shift = self.bn.affine()
        return self.conv(x, post_scale=scale, post_shift=shift, post_relu=self.relu, op=op)


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

    def forward(self, x, op=None):
        if self.training:
            y = self.bn(self.deconv(x, op=op))
            return torch.relu(y) if self.relu else y
        scale, shift = self.bn.affine()
        return self.deconv(x, post_scale=scale, post_shift=shift,
                           post_relu=self.relu, op=op)


def reset_parameters(module: nn.Module, seed: int) -> None:
    """Seeded init of every conv and transposed-conv kernel in `module`, in
    module order; norms keep their identity init."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, _ConvBase):
            m.reset_parameters(g)


class Fc(nn.Module):
    """Dense layer with optional flatten (layers.py:905-918; reference:
    network.py:462-476): flax's (in, out) `kernel` and `bias`, the product
    in `dtype` (else the promotion of the input's and float32), then ReLU."""

    def __init__(self, num_in: int, num_out: int, relu: bool = True, use_bias: bool = True,
                 flatten: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((num_in, num_out), dtype=torch.float32))
        self.bias = (nn.Parameter(torch.zeros(num_out, dtype=torch.float32))
                     if use_bias else None)
        self.relu, self.flatten, self.dtype = relu, flatten, dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Lecun-normal kernel (std 1/sqrt(fan_in)), zero bias."""
        with torch.no_grad():
            self.kernel.copy_(torch.randn(self.kernel.shape, generator=generator)
                              / math.sqrt(self.kernel.shape[0]))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        dtype = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return torch.relu(y) if self.relu else y


class Dropout(nn.Module):
    """(layers.py:944-951; reference: network.py:511-517) The identity
    unless called with `training=True`, as flax's is."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, training: bool = False):
        return F.dropout(x, self.rate, training=training)


def _pool_window(x, pool_size: int, strides: int, padding: str, value: float):
    """NHWC x padded for a `padding` ("SAME" or "VALID") window as XLA's
    reduce_window pads it, as NCHW for torch's pools."""
    x = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        pads = []
        for n in (x.shape[3], x.shape[2]):
            out = -(-n // strides)
            total = max((out - 1) * strides + pool_size - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads, value=value)
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r} (SAME or VALID)")
    return x


def max_pool(x, pool_size: int = 2, strides: int = 2, padding: str = "SAME"):
    """(layers.py:921-925; reference: network.py:417-423) NHWC, the padding
    never wins."""
    y = F.max_pool2d(_pool_window(x, pool_size, strides, padding, -math.inf), pool_size,
                     strides)
    return y.permute(0, 2, 3, 1)


def avg_pool(x, pool_size: int = 2, strides: int = 2, padding: str = "SAME"):
    """(layers.py:928-934; reference: network.py:426-432) NHWC, each window's
    sum over the count of its taps inside the image."""
    summed = F.avg_pool2d(_pool_window(x, pool_size, strides, padding, 0.0), pool_size, strides,
                          divisor_override=1)
    counts = F.avg_pool2d(_pool_window(torch.ones_like(x), pool_size, strides, padding, 0.0),
                          pool_size, strides, divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1)


def l2_pool(x, pool_size: int = 2, strides: int = 2, padding: str = "SAME"):
    """sqrt(avg_pool(x^2)) + eps (layers.py:937-939; reference: network.py:435-442)"""
    return torch.sqrt(avg_pool(torch.square(x), pool_size, strides, padding) + 1e-6)

