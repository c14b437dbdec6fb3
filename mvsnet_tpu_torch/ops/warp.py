"""Homography warping, bilinear with zero fill (counterpart of
mvsnet_tpu/ops/warp.py:31-120).

The homographies act on image coordinates (pixel centres at +0.5): H is
evaluated at (x+0.5, y+0.5, 1) and 0.5 is subtracted from the projection.
Sampling writes the four taps out with floor and a validity test per tap;
`F.grid_sample` is not used because its coordinate normalisation rounds
differently at integer positions.
"""

from __future__ import annotations

import torch


def _pixel_grid(height: int, width: int, device, row_offset: int = 0) -> torch.Tensor:
    """(3, H*W) homogeneous grid: rows x+0.5, y+0.5, 1, for the `height`
    image rows that start at `row_offset`."""
    x = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(row_offset, row_offset + height, dtype=torch.float32,
                     device=device) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1),
                        torch.ones_like(xx).reshape(-1)], dim=0)


def projected_coords(homography, height: int, width: int, eps: float = 1e-7,
                     row_offset: int = 0):
    """Project the reference pixel grid through H, in float32.

    homography: (..., 3, 3). Returns (x, y), each (..., H*W), the source
    pixel coordinates (centres at integers) of the `height` reference rows
    that start at `row_offset`.
    """
    homography = homography.to(torch.float32)
    uvw = homography @ _pixel_grid(height, width, homography.device, row_offset)
    w = uvw[..., 2, :]
    small = w.abs() < eps
    w = torch.where(small, torch.where(w < 0, -eps, eps), w)
    x = uvw[..., 0, :] / w - 0.5
    y = uvw[..., 1, :] / w - 0.5
    return x, y


def bilinear_sample(image, x, y) -> torch.Tensor:
    """Sample (H, W, C) `image` at pixel coordinates x, y (each (N,)).

    Taps outside the image contribute 0. The weights and the blend run in
    the image's dtype, as in the JAX reference. Returns (N, C).
    """
    H, W, C = image.shape
    dtype = image.dtype
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f).to(dtype)[:, None]
    fy = (y - y0f).to(dtype)[:, None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = image.reshape(H * W, C)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat.index_select(0, idx)
        return torch.where(valid[:, None], vals, torch.zeros((), dtype=dtype,
                                                             device=vals.device))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))
