"""Fused warp + variance cost volume: kernels K1 and K1s
(`csrc/cost_volume.cu`).

K1 replaces the Pallas cost kernels of mvsnet_tpu/ops/pallas/sweep.py
(`_preload_call_group` at sweep.py:1094, `_preload_call` at :1322 and
`_pallas_cost_volume_blockres` at :1888), three editions of one function.
K1s replaces their row- and depth-sliced edition of multi-device serving
(`pallas_sweep_cost_volume_sharded`, sweep.py:2032, and the `row_offset` /
`out_rows` route of `_pallas_cost_volume_preload`, :1233-1260): the same
source compiled with a row offset, the reference map and the output
holding the rank's rows and the homographies its depth slab, the source
maps whole.

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

# Launches of the CUDA kernel in this process: as K1 (whole maps) and as
# K1s (called with a row offset, from the sharded cost volume).
launches = 0
launches_sharded = 0

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_I, _P, _P, _P, _P] + [_I] * 7 + [_P]


def cost_volume_plain(ref, views, homs, row_offset=None):
    """Plain PyTorch version: the explicit gather warp of `ops/warp.py`,
    in float32.

    ref (hl, w, C), views (V-1, h, w, C), homs (V-1, D, 3, 3) ->
    (D, hl, w, C) in ref's dtype: the rows [row_offset, row_offset + hl)
    of the cost volume (row_offset None: hl = h, the whole volume).
    """
    Hl, W, C = ref.shape
    V1, D = homs.shape[:2]
    ref32 = ref.to(torch.float32)
    s = ref32.expand(D, Hl, W, C).clone()
    s2 = (ref32 * ref32).expand(D, Hl, W, C).clone()
    for v in range(V1):
        x, y = warp.projected_coords(homs[v], Hl, W, row_offset=row_offset or 0)
        warped = warp.bilinear_sample(views[v].to(torch.float32),
                                      x.reshape(-1), y.reshape(-1))
        warped = warped.reshape(D, Hl, W, C)
        s += warped
        s2 += warped * warped
    mean = s / (V1 + 1)
    return (s2 / (V1 + 1) - mean * mean).to(ref.dtype)


def cost_volume(ref, views, homs, row_offset=None):
    """Variance cost volume of one batch element, (D, hl, w, C) in ref's
    dtype; see `cost_volume_plain` for the arguments. `row_offset=None`
    launches K1 (ref and views of one height); an int launches K1s, which
    counts in `launches_sharded`."""
    global launches, launches_sharded
    if ref.device.type == "cpu":
        return cost_volume_plain(ref, views, homs, row_offset)
    ref = ref.contiguous()
    views = views.contiguous()
    homs = homs.to(torch.float32).contiguous()
    _lib.require_cuda(ref, views, homs)
    Hl, W, C = ref.shape
    V1, D = homs.shape[:2]
    H = views.shape[1]
    r0 = 0 if row_offset is None else int(row_offset)
    if views.shape != (V1, H, W, C) or views.dtype != ref.dtype:
        raise ValueError(f"views {tuple(views.shape)} {views.dtype} do not match "
                         f"ref {tuple(ref.shape)} {ref.dtype} and {V1} homographies")
    if (row_offset is None and Hl != H) or not 0 <= r0 <= H - Hl:
        raise ValueError(f"reference rows [{r0}, {r0 + Hl}) do not fit source maps of "
                         f"{H} rows (row_offset {row_offset})")
    if homs.shape != (V1, D, 3, 3):
        raise ValueError(f"homographies must be (V-1, D, 3, 3), got {tuple(homs.shape)}")
    if C % 8:
        raise ValueError(f"the cost kernel takes channels in multiples of 8, got {C}")
    out = torch.empty((D, Hl, W, C), dtype=ref.dtype, device=ref.device)
    fn = _lib.launcher("cost_volume", _ARGTYPES)
    err = fn(_lib.dtype_code(ref), _lib.ptr(ref), _lib.ptr(views), _lib.ptr(homs),
             _lib.ptr(out), V1, D, Hl, H, W, C, r0, _lib.stream_of(ref))
    _lib.check("cost_volume", err)
    if row_offset is None:
        launches += 1
    else:
        launches_sharded += 1
    return out
