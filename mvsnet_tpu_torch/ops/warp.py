"""Homography warping, bilinear with zero fill or clamped to the edge
(counterpart of mvsnet_tpu/ops/warp.py).

The homographies act on image coordinates (pixel centres at +0.5): H is
evaluated at (x+0.5, y+0.5, 1) and 0.5 is subtracted from the projection.
Sampling writes the four taps out with floor and a validity test per tap;
`F.grid_sample` is not used because its coordinate normalisation rounds
differently at integer positions.

`fill_mode="zeros"` (every path of the model) lets taps outside the image
contribute 0; `warp_by_homographies` then runs the warp kernel K2 on CUDA
tensors (`ops/kernels/warp.py`). `fill_mode="edge"` clamps the taps to the
border as the reference's manual warp does (homography_warping.py:146-149);
no kernel samples that way, so it is plain PyTorch on any device.
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


def bilinear_sample(image, x, y, fill_mode: str = "zeros") -> torch.Tensor:
    """Sample (H, W, C) `image` at pixel coordinates x, y (each (N,)).

    fill_mode "zeros": taps outside the image contribute 0. "edge": the
    top-left tap is clamped into the image and the other taps are its
    clamped neighbours, with the weights of the unclamped position (JAX's
    order, ops/warp.py:123-170). The weights and the blend run in the
    image's dtype, as in the JAX reference. Returns (N, C).
    """
    if fill_mode not in ("zeros", "edge"):
        raise ValueError(f"fill_mode must be 'zeros' or 'edge', not {fill_mode!r}")
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

    if fill_mode == "edge":
        x0, y0 = x0.clamp(0, W - 1), y0.clamp(0, H - 1)
        x1, y1 = (x0 + 1).clamp(0, W - 1), (y0 + 1).clamp(0, H - 1)
    else:
        x1, y1 = x0 + 1, y0 + 1
    v00 = tap(y0, x0)
    v01 = tap(y0, x1)
    v10 = tap(y1, x0)
    v11 = tap(y1, x1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def homography_warp(image, homography, fill_mode: str = "zeros") -> torch.Tensor:
    """Warp (B, H, W, C) by one homography (B, 3, 3) per batch element:
    output[b, y, x] = image[b] sampled at H_b (x+0.5, y+0.5, 1). Plain
    PyTorch in the image's dtype."""
    B, H, W, C = image.shape
    out = []
    for b in range(B):
        x, y = projected_coords(homography[b], H, W)
        out.append(bilinear_sample(image[b], x, y, fill_mode).reshape(H, W, C))
    return torch.stack(out, dim=0)


def warp_by_homographies(image, homographies, fill_mode: str = "zeros") -> torch.Tensor:
    """Warp one image by many homographies (the plane sweep): image (B, H,
    W, C), homographies (B, D, 3, 3) -> (B, D, H, W, C). "zeros" is the
    warp kernel K2 on CUDA tensors and its plain version (float32 blend,
    one cast) on CPU tensors; "edge" is plain PyTorch in the image's
    dtype."""
    from mvsnet_tpu_torch.ops.kernels import warp as warp_k

    B, H, W, C = image.shape
    out = []
    for b in range(B):
        if fill_mode == "zeros":
            out.append(warp_k.warp_all_depths(image[b].contiguous(),
                                              homographies[b].contiguous()))
            continue
        x, y = projected_coords(homographies[b], H, W)
        out.append(bilinear_sample(image[b], x.reshape(-1), y.reshape(-1), fill_mode)
                   .reshape(-1, H, W, C))
    return torch.stack(out, dim=0)
