"""All-depth homography warp and its adjoint: kernels K2 and K3
(`csrc/warp.cu`).

K2 replaces the Pallas warp kernels of mvsnet_tpu/ops/pallas/sweep.py
(`pallas_warp_all_depths` at sweep.py:1599 and
`_pallas_warp_all_depths_preload` at :1538); K3 replaces the transposed
warp `_pallas_warp_transpose` (:1701). Both sample through the same taps
as the cost volume K1 (`csrc/common.cuh`). K2 is bound by bytes (its
output is D times its input) and writes each output element once, in
16-byte vectors. K3 is a scatter: it adds into its float32 output with
atomics, so the order of its sums is not fixed from run to run; each
thread keeps the taps' sums in registers across the depths whose top-left
tap stays on one source pixel, which cuts the atomics.

`warp_all_depths` and `warp_transpose` run their kernels on CUDA tensors
and their `*_plain` versions on CPU tensors; they never fall back from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from mvsnet_tpu_torch.ops import warp as warp_ops
from mvsnet_tpu_torch.ops.kernels import _lib

# Launches of each CUDA kernel in this process.
launches = 0              # K2, warp_all_depths
transpose_launches = 0    # K3, warp_transpose

# Depths one thread of K3 walks (one grid row of the launch each).
TRANSPOSE_DEPTH_SEGMENT = 16

_I = ctypes.c_int
_P = ctypes.c_void_p
_WARP_ARGTYPES = [_I, _P, _P, _P, _I, _I, _I, _I, _P]
_TRANSPOSE_ARGTYPES = [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def warp_all_depths_plain(img, homs):
    """Plain PyTorch version: the explicit four-tap gather of `ops/warp.py`
    in float32, cast once to img's dtype.

    img (H, W, C), homs (D, 3, 3) -> (D, H, W, C) in img's dtype.
    """
    H, W, C = img.shape
    D = homs.shape[0]
    x, y = warp_ops.projected_coords(homs, H, W)
    out = warp_ops.bilinear_sample(img.to(torch.float32), x.reshape(-1), y.reshape(-1))
    return out.reshape(D, H, W, C).to(img.dtype)


def warp_transpose_plain(g, homs):
    """Plain PyTorch version of the adjoint: every cotangent element is
    added, times its bilinear weight, into each of its four taps that lies
    inside the map (`index_add_`), in float32.

    g (D, H, W, C), homs (D, 3, 3) -> (H, W, C) float32.
    """
    D, H, W, C = g.shape
    x, y = warp_ops.projected_coords(homs, H, W)
    x, y = x.reshape(-1), y.reshape(-1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    gf = g.to(torch.float32).reshape(-1, C)
    out = torch.zeros((H * W, C), dtype=torch.float32, device=g.device)
    for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        out.index_add_(0, idx, gf * torch.where(valid, wt, 0.0)[:, None])
    return out.reshape(H, W, C)


def _check(name, maps, homs, lead):
    if maps.ndim != lead + 3 or homs.ndim != 3 or homs.shape[1:] != (3, 3):
        raise ValueError(f"{name}: maps {tuple(maps.shape)} and homographies "
                         f"{tuple(homs.shape)} do not match")
    if maps.shape[-1] % 8:
        raise ValueError(f"the warp kernels take channels in multiples of 8, "
                         f"got {maps.shape[-1]}")


def warp_all_depths(img, homs):
    """Warp img (H, W, C) by homs (D, 3, 3): (D, H, W, C) in img's dtype,
    zero-fill bilinear with float32 weights and sums."""
    global launches
    if img.device.type == "cpu":
        return warp_all_depths_plain(img, homs)
    _check("warp_all_depths", img, homs, 0)
    img = img.contiguous()
    homs = homs.to(torch.float32).contiguous()
    _lib.require_cuda(img, homs)
    H, W, C = img.shape
    D = homs.shape[0]
    out = torch.empty((D, H, W, C), dtype=img.dtype, device=img.device)
    fn = _lib.launcher("warp", _WARP_ARGTYPES)
    err = fn(_lib.dtype_code(img), _lib.ptr(img), _lib.ptr(homs), _lib.ptr(out),
             D, H, W, C, _lib.stream_of(img))
    _lib.check("warp", err)
    launches += 1
    return out


def warp_transpose(g, homs):
    """Adjoint of `warp_all_depths` in the source map: g (D, H, W, C)
    cotangents (float32 or bfloat16) -> (H, W, C) float32."""
    global transpose_launches
    if g.device.type == "cpu":
        return warp_transpose_plain(g, homs)
    _check("warp_transpose", g, homs, 1)
    g = g.contiguous()
    homs = homs.to(torch.float32).contiguous()
    _lib.require_cuda(g, homs)
    D, H, W, C = g.shape
    if homs.shape[0] != D:
        raise ValueError(f"{D} cotangent planes for {homs.shape[0]} homographies")
    out = torch.zeros((H, W, C), dtype=torch.float32, device=g.device)
    fn = _lib.launcher("warp", _TRANSPOSE_ARGTYPES, entry="transpose_launch")
    err = fn(_lib.dtype_code(g), _lib.ptr(g), _lib.ptr(homs), _lib.ptr(out),
             D, H, W, C, TRANSPOSE_DEPTH_SEGMENT, _lib.stream_of(g))
    _lib.check("warp", err)
    transpose_launches += 1
    return out
