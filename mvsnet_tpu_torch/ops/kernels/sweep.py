"""Fused warp + variance cost volume: kernel K1 (`csrc/cost_volume.cu`).

Replaces the Pallas cost kernels of mvsnet_tpu/ops/pallas/sweep.py
(`_preload_call_group` at sweep.py:1094, `_preload_call` at :1322 and
`_pallas_cost_volume_blockres` at :1888), three editions of one function.
On the H100 the kernel is bound by bytes: its output is D/V times the size
of its inputs. It writes each output element once, in 16-byte vectors, and
never writes a warped view to device memory; the source maps stay in L2.

`cost_volume` runs the kernel on CUDA tensors and `cost_volume_plain` on CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from mvsnet_tpu_torch.ops import warp
from mvsnet_tpu_torch.ops.kernels import _lib

# Launches of the CUDA kernel in this process.
launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def cost_volume_plain(ref, views, homs):
    """Plain PyTorch version: the explicit gather warp of `ops/warp.py`,
    in float32.

    ref (h, w, C), views (V-1, h, w, C), homs (V-1, D, 3, 3) ->
    (D, h, w, C) in ref's dtype.
    """
    H, W, C = ref.shape
    V1, D = homs.shape[:2]
    ref32 = ref.to(torch.float32)
    s = ref32.expand(D, H, W, C).clone()
    s2 = (ref32 * ref32).expand(D, H, W, C).clone()
    for v in range(V1):
        x, y = warp.projected_coords(homs[v], H, W)                 # (D, h*w)
        warped = warp.bilinear_sample(views[v].to(torch.float32),
                                      x.reshape(-1), y.reshape(-1))
        warped = warped.reshape(D, H, W, C)
        s += warped
        s2 += warped * warped
    mean = s / (V1 + 1)
    return (s2 / (V1 + 1) - mean * mean).to(ref.dtype)


def cost_volume(ref, views, homs):
    """Variance cost volume of one batch element, (D, h, w, C) in ref's
    dtype; see `cost_volume_plain` for the arguments."""
    global launches
    if ref.device.type == "cpu":
        return cost_volume_plain(ref, views, homs)
    ref = ref.contiguous()
    views = views.contiguous()
    homs = homs.to(torch.float32).contiguous()
    _lib.require_cuda(ref, views, homs)
    H, W, C = ref.shape
    V1, D = homs.shape[:2]
    if views.shape != (V1, H, W, C) or views.dtype != ref.dtype:
        raise ValueError(f"views {tuple(views.shape)} {views.dtype} do not match "
                         f"ref {tuple(ref.shape)} {ref.dtype} and {V1} homographies")
    if homs.shape != (V1, D, 3, 3):
        raise ValueError(f"homographies must be (V-1, D, 3, 3), got {tuple(homs.shape)}")
    if C % 8:
        raise ValueError(f"the cost kernel takes channels in multiples of 8, got {C}")
    out = torch.empty((D, H, W, C), dtype=ref.dtype, device=ref.device)
    fn = _lib.launcher("cost_volume", _ARGTYPES)
    err = fn(_lib.dtype_code(ref), _lib.ptr(ref), _lib.ptr(views), _lib.ptr(homs),
             _lib.ptr(out), V1, D, H, W, C, _lib.stream_of(ref))
    _lib.check("cost_volume", err)
    launches += 1
    return out
