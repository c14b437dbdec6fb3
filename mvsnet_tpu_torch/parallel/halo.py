"""3x3x3 convs on depth slabs with a halo exchange over 'depth': the U-Net
sharding that GSPMD derives in the JAX package (models/mvsnet.py:174,
models/regnet.py:10), written out.

A rank holds the slab of Dl planes at global offset r * Dl of a volume of
D = n * Dl planes, (B, Dl, h, w, C), rows and columns whole. Zero planes
stand beyond the global ends. From the kernels' index rules:

  * stride-1 SAME conv (pads 1/1): one plane from each neighbour, then
    depth pads (0, 0): Dl outputs;
  * stride-2 SAME conv on even D (pads 0/1): output o reads 2o..2o+2, so
    one plane from the next rank, then depth pads (0, 0): Dl/2 outputs,
    Dl even;
  * stride-2 transposed conv, out[o] = sum_t k[2-t] x[(o-t)/2]: output o
    reads x[o//2] and x[o//2 - 1], so one plane from the previous rank,
    prepended, then `deconv(lo=2)` over 2 Dl outputs.

One `all_gather` over the depth group of every rank's (first, last) planes
serves each exchange: deadlock-free, and the same on gloo and NCCL.
"""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import deconv as deconv_k


def exchange(x, mesh):
    """(previous rank's last plane, next rank's first plane) of the slab x
    (B, Dl, h, w, C), each (B, 1, h, w, C); zeros beyond the global ends."""
    n, r = mesh.axis_size("depth"), mesh.axis_index("depth")
    zero = torch.zeros_like(x[:, :1])
    if n == 1:
        return zero, zero
    ends = torch.stack([x[:, 0], x[:, -1]], dim=1)           # (B, 2, h, w, C)
    every = mesh.all_gather(ends[None], "depth", dim=0)       # (n, B, 2, h, w, C)
    before = every[r - 1][:, 1:2] if r > 0 else zero
    after = every[r + 1][:, 0:1] if r < n - 1 else zero
    return before, after


def _hw_pads(x, stride):
    return [conv_k.same_pads(n, 3, stride)[:2] for n in x.shape[2:4]]


def halo_conv(x, kernel, bias, stride: int, relu: bool, mesh):
    """The depth slab of conv(whole volume, kernel, bias, stride, relu) for
    a 3x3x3 SAME conv of stride 1 or 2; see the module docstring."""
    if tuple(kernel.shape[:3]) != (3, 3, 3):
        raise ValueError(f"halo_conv takes 3x3x3 kernels, got {tuple(kernel.shape)}")
    before, after = exchange(x, mesh)
    if stride == 1:
        xx = torch.cat([before, x, after], dim=1)
    elif stride == 2:
        if x.shape[1] % 2:
            raise ValueError(f"a stride-2 halo conv needs an even slab, got {x.shape[1]} planes")
        xx = torch.cat([x, after], dim=1)
    else:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    return conv_k.conv(xx, kernel, bias, stride, relu, pads=[(0, 0)] + _hw_pads(x, stride))


def halo_deconv(x, kernel, bias, relu: bool, mesh):
    """The depth slab (2 Dl planes) of flax's k3 s2 SAME transposed conv of
    the whole volume; see the module docstring."""
    before, _ = exchange(x, mesh)
    B, Dl, h, w, _ = x.shape
    return deconv_k.deconv(torch.cat([before, x], dim=1), kernel, bias, relu,
                           lo=(2, 0, 0), out_spatial=(2 * Dl, 2 * h, 2 * w))
