"""All-depth homography warp and its adjoint: kernels K2 and K3
(`csrc/warp.cu`).

K2 replaces the Pallas warp kernels of mvsnet_tpu/ops/pallas/sweep.py
(`pallas_warp_all_depths` at sweep.py:1599 and
`_pallas_warp_all_depths_preload` at :1538); K3 replaces the transposed
warp `_pallas_warp_transpose` (:1701). Both sample through the same taps
as the cost volume K1 (`csrc/common.cuh`). K2 is bound by bytes (its
output is D times its input) and is K1's design with one view: tiles of
rows, a table of taps in shared memory, streaming stores. K3 is a gather
in which each output element is summed by one thread in a fixed order, so
it needs no atomics and two calls are equal bit for bit; `transpose_plan`
gives it each plane's inverse homography, which bounds the reference
pixels that can feed a tile, and flags the planes where that bound does
not hold (the whole map is then scanned).

Both take a block of reference rows (`row_offset`), as K1s does for the
cost kernel: K2 then warps the rows [row_offset, row_offset + rows) of the
output, K3 takes those rows' cotangents and returns the whole source map's
gradient. The multi-device train step runs its cost-volume block through
them (`ops/cost_volume.py`); their launches count apart.

`warp_all_depths` and `warp_transpose` run their kernels on CUDA tensors
and their `*_plain` versions on CPU tensors; they never fall back from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from mvsnet_tpu_torch.ops import warp as warp_ops
from mvsnet_tpu_torch.ops.kernels import _lib

# Launches of each CUDA kernel in this process, whole maps and row blocks.
launches = 0                      # K2, warp_all_depths
transpose_launches = 0            # K3, warp_transpose
launches_sharded = 0              # K2 with a row offset
transpose_launches_sharded = 0    # K3 with a row offset

_I = ctypes.c_int
_P = ctypes.c_void_p
_WARP_ARGTYPES = [_I, _P, _P, _P] + [_I] * 6 + [_P]
_TRANSPOSE_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P] + [_I] * 7 + [_P]
_PLAN_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]

# K3 tiles: TILE_ROWS source rows (a warp each, csrc/warp.cu kRows) of
# 32 / (C / lane_channels(C)) pixels; BLOCKS_PER_SM blocks fit an SM (its
# shared memory holds two).
TILE_ROWS = 8
BLOCKS_PER_SM = 2


def _rows(H, row_offset, rows):
    """(first reference row, rows) of a block of an H-row map: the whole map
    for row_offset None."""
    if row_offset is None:
        return 0, H
    r0, n = int(row_offset), int(H - row_offset if rows is None else rows)
    if not (0 <= r0 and n >= 1 and r0 + n <= H):
        raise ValueError(f"reference rows [{r0}, {r0 + n}) do not fit a map of {H} rows")
    return r0, n


def warp_all_depths_plain(img, homs, row_offset=None, rows=None):
    """Plain PyTorch version: the explicit four-tap gather of `ops/warp.py`
    in float32, cast once to img's dtype.

    img (H, W, C), homs (D, 3, 3) -> (D, Hr, W, C) in img's dtype: the
    reference rows [row_offset, row_offset + rows) (None: all H).
    """
    H, W, C = img.shape
    D = homs.shape[0]
    r0, Hr = _rows(H, row_offset, rows)
    x, y = warp_ops.projected_coords(homs, Hr, W, row_offset=r0)
    out = warp_ops.bilinear_sample(img.to(torch.float32), x.reshape(-1), y.reshape(-1))
    return out.reshape(D, Hr, W, C).to(img.dtype)


def warp_transpose_plain(g, homs, row_offset=None, height=None):
    """Plain PyTorch version of the adjoint: every cotangent element is
    added, times its bilinear weight, into each of its four taps that lies
    inside the map (`index_add_`), in float32.

    g (D, Hr, W, C), the cotangents of the reference rows [row_offset,
    row_offset + Hr) (None: the whole map), homs (D, 3, 3) -> (H, W, C)
    float32, H = `height` (default Hr).
    """
    D, Hr, W, C = g.shape
    H = Hr if height is None else int(height)
    r0, _ = _rows(H, row_offset, Hr)
    x, y = warp_ops.projected_coords(homs, Hr, W, row_offset=r0)
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


def lane_channels(C):
    """Channels one K3 lane sums for its pixel: 32, 16 or 8."""
    return 32 if C % 32 == 0 else 16 if C % 16 == 0 else 8


def transpose_tiles(H, W, C):
    """K3's source tiles: (rows, columns) of tiles of TILE_ROWS x 32 /
    (C / lane_channels(C)) pixels."""
    tx = 32 // (C // lane_channels(C))
    return -(-H // TILE_ROWS), -(-W // tx)


def transpose_segments(D, H, W, C, sms):
    """Depth runs K3 splits its planes into, summed apart and then in
    order: enough blocks (tiles x runs) to keep BLOCKS_PER_SM on each of
    `sms` SMs in one wave, at least 1, at most D."""
    ty, tx = transpose_tiles(H, W, C)
    return max(1, min(D, BLOCKS_PER_SM * sms // (ty * tx)))


def transpose_plan(homs, H, W, row_offset: int = 0):
    """K3's plan of D homographies over the H reference rows from
    `row_offset` of width W: (inv, wsign). On a CUDA tensor it is `csrc/warp.cu`'s plan kernel, which
    `warp_transpose` launches before its gather; on the CPU, the same float64
    arithmetic in PyTorch.

    inv (D, 3, 3) float32: each H_d^-1 by the adjugate of float32 H_d (as
    the kernels project with it), in float64, cast once. wsign (D,) int32:
    the sign of w = h6 (x + 0.5) + h7 (y + 0.5) + h8 over the map's pixel
    centres, +1 or -1; 0 where w changes sign there or comes within 1e-7
    (plus a float32 rounding margin) of 0 at a corner of those rows (w is
    affine, so its corners bound it), or where inv is not finite. On a plane of sign s the
    gather bounds a tile's contributors by its source box's corners mapped
    through inv; a plane of sign 0 is scanned whole.
    """
    homs = homs.to(torch.float32).contiguous()
    D = homs.shape[0]
    if homs.device.type != "cpu":
        _lib.require_cuda(homs)
        inv = torch.empty((D, 3, 3), dtype=torch.float32, device=homs.device)
        wsign = torch.empty((D,), dtype=torch.int32, device=homs.device)
        fn = _lib.launcher("warp", _PLAN_ARGTYPES, entry="plan_launch")
        _lib.check("warp", fn(_lib.ptr(homs), _lib.ptr(inv), _lib.ptr(wsign), D, H,
                              int(row_offset), W, _lib.stream_of(homs)))
        return inv, wsign
    h = homs.to(torch.float64).reshape(D, 9).unbind(1)
    adj = torch.stack([h[4] * h[8] - h[5] * h[7], h[2] * h[7] - h[1] * h[8],
                       h[1] * h[5] - h[2] * h[4], h[5] * h[6] - h[3] * h[8],
                       h[0] * h[8] - h[2] * h[6], h[2] * h[3] - h[0] * h[5],
                       h[3] * h[7] - h[4] * h[6], h[1] * h[6] - h[0] * h[7],
                       h[0] * h[4] - h[1] * h[3]], dim=1)
    det = h[0] * adj[:, 0] + h[1] * adj[:, 3] + h[2] * adj[:, 6]
    inv = (adj / det[:, None]).to(torch.float32)
    px = torch.tensor([0.5, W - 0.5, 0.5, W - 0.5], dtype=torch.float64)
    r0 = float(row_offset)
    py = torch.tensor([r0 + 0.5, r0 + 0.5, r0 + H - 0.5, r0 + H - 0.5], dtype=torch.float64)
    h6, h7, h8 = h[6][:, None], h[7][:, None], h[8][:, None]
    w = h6 * px + h7 * py + h8                            # (D, 4 corners)
    margin = 1e-7 + 1e-6 * (h6.abs() * px + h7.abs() * py + h8.abs())
    pos, neg = (w > margin).all(dim=1), (w < -margin).all(dim=1)
    ok = torch.isfinite(inv).all(dim=1)
    wsign = ((pos.to(torch.int32) - neg.to(torch.int32)) * ok.to(torch.int32))
    return inv.reshape(D, 3, 3), wsign


def _check(name, maps, homs, lead):
    if maps.ndim != lead + 3 or homs.ndim != 3 or homs.shape[1:] != (3, 3):
        raise ValueError(f"{name}: maps {tuple(maps.shape)} and homographies "
                         f"{tuple(homs.shape)} do not match")
    if maps.shape[-1] % 8:
        raise ValueError(f"the warp kernels take channels in multiples of 8, "
                         f"got {maps.shape[-1]}")


def warp_all_depths(img, homs, row_offset=None, rows=None):
    """Warp img (H, W, C) by homs (D, 3, 3): (D, Hr, W, C) in img's dtype,
    zero-fill bilinear with float32 weights and sums, for the reference
    rows [row_offset, row_offset + rows) (row_offset None: the whole map,
    Hr = H; an int: a row block, counted in `launches_sharded`)."""
    global launches, launches_sharded
    if img.device.type == "cpu":
        return warp_all_depths_plain(img, homs, row_offset, rows)
    _check("warp_all_depths", img, homs, 0)
    img = img.contiguous()
    homs = homs.to(torch.float32).contiguous()
    _lib.require_cuda(img, homs)
    H, W, C = img.shape
    D = homs.shape[0]
    r0, Hr = _rows(H, row_offset, rows)
    out = torch.empty((D, Hr, W, C), dtype=img.dtype, device=img.device)
    fn = _lib.launcher("warp", _WARP_ARGTYPES)
    err = fn(_lib.dtype_code(img), _lib.ptr(img), _lib.ptr(homs), _lib.ptr(out),
             D, Hr, H, W, C, r0, _lib.stream_of(img))
    _lib.check("warp", err)
    if row_offset is None:
        launches += 1
    else:
        launches_sharded += 1
    return out


def warp_transpose(g, homs, row_offset=None, height=None):
    """Adjoint of `warp_all_depths` in the source map: g (D, Hr, W, C)
    cotangents (float32 or bfloat16) of the reference rows [row_offset,
    row_offset + Hr) -> (H, W, C) float32, H = `height` (row_offset None:
    the whole map, H = Hr; an int: a row block, counted in
    `transpose_launches_sharded`). On the card the sums run in a fixed
    order: two calls on the same inputs are equal bit for bit."""
    global transpose_launches, transpose_launches_sharded
    if g.device.type == "cpu":
        return warp_transpose_plain(g, homs, row_offset, height)
    _check("warp_transpose", g, homs, 1)
    g = g.contiguous()
    homs = homs.to(torch.float32).contiguous()
    _lib.require_cuda(g, homs)
    D, Hr, W, C = g.shape
    H = Hr if height is None else int(height)
    r0, _ = _rows(H, row_offset, Hr)
    if homs.shape[0] != D:
        raise ValueError(f"{D} cotangent planes for {homs.shape[0]} homographies")
    inv, wsign = transpose_plan(homs, Hr, W, r0)
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    segments = transpose_segments(D, H, W, C, sms)
    part = torch.empty((segments if segments > 1 else 0, H, W, C), dtype=torch.float32,
                       device=g.device)
    out = torch.empty((H, W, C), dtype=torch.float32, device=g.device)   # all written
    fn = _lib.launcher("warp", _TRANSPOSE_ARGTYPES, entry="transpose_launch")
    err = fn(_lib.dtype_code(g), _lib.ptr(g), _lib.ptr(homs), _lib.ptr(inv), _lib.ptr(wsign),
             _lib.ptr(out), _lib.ptr(part), segments, D, Hr, H, W, C, r0, _lib.stream_of(g))
    _lib.check("warp", err)
    if row_offset is None:
        transpose_launches += 1
    else:
        transpose_launches_sharded += 1
    return out
