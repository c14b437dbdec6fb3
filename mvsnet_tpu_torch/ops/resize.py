"""Bilinear resize of channels-last maps (counterpart of
mvsnet_tpu/models/mvsnet.py:44-47, `_resize_bilinear`, which is
`jax.image.resize(x, shape, "bilinear")`).

`jax.image.resize` antialiases by default: each output pixel is a triangle
filter over the input, centred at (o + 0.5) / scale - 0.5 and widened by
1 / scale when the map shrinks (a plain bilinear interpolation when it
grows), its weights normalised over the taps inside the input. The resize
is a product with one such weight matrix per spatial axis whose size
changes, as `jax.image.scale_and_translate` computes it: matrix products on
either device, the same sum order run to run, so two card runs (and their
backward passes) are equal bit for bit.
"""

from __future__ import annotations

import torch


def weight_matrix(in_size: int, out_size: int, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """(in_size, out_size) weights of the antialiased triangle filter
    (`jax._src.image.scale.compute_weight_mat` with translation 0)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    taps = torch.arange(in_size, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - (sample[None, :] - taps[:, None]).abs() / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) in x's dtype, as
    `jax.image.resize(x, (B, height, width, C), "bilinear")`."""
    H, W = x.shape[1:3]
    if height != H:
        x = torch.einsum("bhwc,hy->bywc", x, weight_matrix(H, height, x.device, x.dtype))
    if width != W:
        x = torch.einsum("bywc,wx->byxc", x, weight_matrix(W, width, x.device, x.dtype))
    return x.contiguous()
