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
of its inputs. A block owns a tile of reference pixels and walks a run of
depths, so that neighbouring depths' taps hit L1; each projection is
computed once per (pixel, view, depth); the output leaves in streaming
16-byte stores and the source maps stay in L2 (see the source's note).

`cost_volume` runs the kernel on CUDA tensors and `cost_volume_plain` on CPU
tensors; it never falls back from one to the other.

`pixel_cost_volume` (its plain version `pixel_cost_volume_plain`) is the
per-pixel edition of the same source, for CasMVSNet's cascade: each pixel
has its own plane depths, and each source view a projection [M | b]
instead of a homography a plane. K1's design, its taps and its sums are
kept; its launches count in `launches.cost_volume_pixel`.
"""

from __future__ import annotations

import ctypes

import torch

from mvsnet_tpu_torch.ops import warp
from mvsnet_tpu_torch.ops.kernels import _lib
from mvsnet_tpu_torch.utils import profiling

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_I, _P, _P, _P, _P] + [_I] * 7 + [_P]
_PIXEL_ARGTYPES = [_I, _P, _P, _P, _P, _P] + [_I] * 6 + [_P]


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
    launches K1 (ref and views of one height), counted in
    `launches.cost_volume`; an int launches K1s, counted in
    `launches.cost_volume_sharded`."""
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
    if C % 8 or C > 256:
        raise ValueError(f"the cost kernel takes channels in multiples of 8 up to 256, got {C}")
    if V1 * H * W * C >= 2 ** 31:
        raise ValueError(f"source maps of {V1 * H * W * C} elements exceed the kernel's "
                         f"32-bit indexing")
    out = torch.empty((D, Hl, W, C), dtype=ref.dtype, device=ref.device)
    fn = _lib.launcher("cost_volume", _ARGTYPES)
    err = fn(_lib.dtype_code(ref), _lib.ptr(ref), _lib.ptr(views), _lib.ptr(homs),
             _lib.ptr(out), V1, D, Hl, H, W, C, r0, _lib.stream_of(ref))
    _lib.check("cost_volume", err)
    profiling.count("launches.cost_volume" if row_offset is None
                    else "launches.cost_volume_sharded")
    return out


def _pixel_check(ref, views, planes, proj):
    H, W, C = ref.shape
    V1 = views.shape[0]
    if views.shape != (V1, H, W, C) or views.dtype != ref.dtype:
        raise ValueError(f"views {tuple(views.shape)} {views.dtype} do not match "
                         f"ref {tuple(ref.shape)} {ref.dtype}")
    if proj.shape != (V1, 3, 4):
        raise ValueError(f"projections must be (V-1, 3, 4), got {tuple(proj.shape)}")
    if planes.ndim not in (1, 3) or (planes.ndim == 3 and planes.shape[1:] != (H, W)):
        raise ValueError(f"planes must be (D,) or (D, {H}, {W}), got {tuple(planes.shape)}")


def pixel_cost_volume_plain(ref, views, planes, proj):
    """Plain PyTorch version, in float32: each view sampled at q = d M (x +
    0.5, y + 0.5, 1) + b with the explicit gather warp of `ops/warp.py`.

    ref (h, w, C), views (V-1, h, w, C), planes (D, h, w) float32 (or (D,),
    one depth a plane), proj (V-1, 3, 4) float32 -> (D, h, w, C) in ref's
    dtype."""
    _pixel_check(ref, views, planes, proj)
    H, W, C = ref.shape
    D = planes.shape[0]
    depth = planes.to(torch.float32).reshape(D, -1)               # (D, 1 or h*w)
    grid = warp._pixel_grid(H, W, ref.device)                      # (3, h*w)
    ref32 = ref.to(torch.float32)
    s = ref32.expand(D, H, W, C).clone()
    s2 = (ref32 * ref32).expand(D, H, W, C).clone()
    for v in range(views.shape[0]):
        m = proj[v].to(torch.float32)
        rays = m[:, :3] @ grid                                     # (3, h*w)
        q = depth[:, None] * rays[None] + m[None, :, 3:]            # (D, 3, h*w)
        z = q[:, 2]
        z = torch.where(z.abs() < 1e-7, torch.where(z < 0, -1e-7, 1e-7), z)
        x, y = q[:, 0] / z - 0.5, q[:, 1] / z - 0.5
        warped = warp.bilinear_sample(views[v].to(torch.float32), x.reshape(-1), y.reshape(-1))
        warped = warped.reshape(D, H, W, C)
        s += warped
        s2 += warped * warped
    V = views.shape[0] + 1
    mean = s / V
    return (s2 / V - mean * mean).to(ref.dtype)


def pixel_cost_volume(ref, views, planes, proj):
    """Variance cost volume of one batch element over per-pixel planes,
    (D, h, w, C) in ref's dtype; see `pixel_cost_volume_plain` for the
    arguments."""
    if ref.device.type == "cpu":
        return pixel_cost_volume_plain(ref, views, planes, proj)
    _pixel_check(ref, views, planes, proj)
    ref, views = ref.contiguous(), views.contiguous()
    planes = planes.to(torch.float32).contiguous()
    proj = proj.to(torch.float32).contiguous()
    _lib.require_cuda(ref, views, planes, proj)
    H, W, C = ref.shape
    V1, D = views.shape[0], planes.shape[0]
    if C % 8 or C > 256:
        raise ValueError(f"the cost kernel takes channels in multiples of 8 up to 256, got {C}")
    if V1 * H * W * C >= 2 ** 31:
        raise ValueError(f"source maps of {V1 * H * W * C} elements exceed the kernel's "
                         f"32-bit indexing")
    out = torch.empty((D, H, W, C), dtype=ref.dtype, device=ref.device)
    fn = _lib.launcher("cost_volume", _PIXEL_ARGTYPES, entry="pixel_launch")
    err = fn(_lib.dtype_code(ref), _lib.ptr(ref), _lib.ptr(views), _lib.ptr(planes),
             _lib.ptr(proj), _lib.ptr(out), V1, D, H, W, C, int(planes.ndim == 3),
             _lib.stream_of(ref))
    _lib.check("cost_volume", err)
    profiling.count("launches.cost_volume_pixel")
    return out
