"""Plane-sweep variance cost volume (counterpart of
mvsnet_tpu/ops/cost_volume.py:95-238 and of the fused-cost custom VJP
`pallas_sweep_cost_volume_ad`, mvsnet_tpu/ops/pallas/sweep.py:1761-1844).

  cost(d) = E_v[f_v(d)^2] - E_v[f_v(d)]^2, reference view included,

with float32 sums. On CUDA tensors each batch element is one launch of the
fused kernel K1, which never writes a warped view to memory. On CPU tensors
the plain version runs in depth chunks that keep its float32 sums under
2 GiB.

With `differentiable=True` the volume is a `CostVolumeFn`: its forward is
K1 and it saves only its inputs; its backward recomputes each source
view's warp (K2), forms the variance cotangents in PyTorch and scatters
them back to the source maps with the transposed warp (K3), in depth
chunks whose V float32 volumes stay under 2 GiB. The homographies get no
gradient (cameras are data), as in the JAX VJP.

`sweep_cost_volume_sharded` is the multi-device edition (kernel K1s): each
rank computes its 'space' rows and its 'depth' slab of the volume, and in
training its backward runs K2 and K3 on the same row block.
`pixel_cost_volume` is CasMVSNet's volume over per-pixel planes (the
per-pixel edition of K1 on CUDA tensors, its plain version on CPU tensors).
`cost_slice` is one plane of the volume in plain PyTorch, with either fill
mode (ops/cost_volume.py:241 of the JAX package, which no graph calls);
`plane_sweep_cost_volume(..., fill_mode="edge")` stacks it over the planes.
"""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.ops.kernels import sweep, warp
from mvsnet_tpu_torch.ops.warp import homography_warp

ACC_LIMIT_BYTES = 2 * 1024 ** 3


def _cost_one(ref, views, homs):
    """(h, w, C), (V-1, h, w, C), (V-1, D, 3, 3) -> (D, h, w, C)."""
    if ref.device.type != "cpu":
        return sweep.cost_volume(ref, views, homs)
    D = homs.shape[1]
    n_chunks = max(1, -(-(D * ref.numel() * 4) // ACC_LIMIT_BYTES))
    chunk = -(-D // n_chunks)
    return torch.cat([sweep.cost_volume(ref, views, homs[:, c0:c0 + chunk])
                      for c0 in range(0, D, chunk)], dim=0)


def cost_volume_backward(ref, views, homs, g, row_offset=None):
    """Gradients of one batch element's cost volume (sweep.py:1793-1841):

      d_ref    = (2/V) sum_d (ref - mean_d) g_d
      d_view_v = warp_v^T ((2/V) (w_vd - mean_d) g_d)

    ref (h, w, C), views (V-1, h, w, C), homs (V-1, D, 3, 3), g (D, h, w,
    C) -> d_ref in ref's dtype, d_views in views' dtype. With `row_offset`
    ref and g hold the rows [row_offset, row_offset + hl) of a block (K1s's
    output) and the views stay whole: the warps run on the block (K2 and K3
    with a row offset), d_views is the whole maps' share."""
    H, W, C = ref.shape
    Hs = views.shape[1]
    V1, D = homs.shape[:2]
    V = V1 + 1
    g32 = g.to(torch.float32)
    ref32 = ref.to(torch.float32)
    n_chunks = max(1, -(-(V * D * H * W * C * 4) // ACC_LIMIT_BYTES))
    dc = -(-D // n_chunks)
    scale = 2.0 / V
    d_ref = torch.zeros((H, W, C), dtype=torch.float32, device=ref.device)
    d_views = [torch.zeros((Hs, W, C), dtype=torch.float32, device=ref.device)
               for _ in range(V1)]
    for c0 in range(0, D, dc):
        gd = g32[c0:c0 + dc]
        # copies: the kernels take 16-byte aligned tensors, and a view's
        # planes from c0 start 36 (v D + c0) bytes into `homs`
        hc = [homs[v, c0:c0 + dc].clone() for v in range(V1)]
        warped = [warp.warp_all_depths(views[v], hc[v], row_offset, H).to(torch.float32)
                  for v in range(V1)]
        mean = ref32[None]
        for w in warped:
            mean = mean + w
        mean = mean / V
        d_ref += scale * torch.sum((ref32[None] - mean) * gd, dim=0)
        for v in range(V1):
            cot = scale * (warped[v] - mean) * gd
            d_views[v] += warp.warp_transpose(cot, hc[v], row_offset, Hs)
    return d_ref.to(ref.dtype), torch.stack(d_views).to(views.dtype)


class CostVolumeFn(torch.autograd.Function):
    """Differentiable cost volume; see the module docstring. With
    `row_offset` the row block of `sweep_cost_volume_sharded`: K1s forward,
    the block's K2 and K3 backward."""

    @staticmethod
    def forward(ctx, ref_feature, view_features, homographies, row_offset=None):
        ctx.save_for_backward(ref_feature, view_features, homographies)
        ctx.row_offset = row_offset
        B = ref_feature.shape[0]
        if row_offset is None:
            outs = [_cost_one(ref_feature[b], view_features[:, b], homographies[:, b])
                    for b in range(B)]
        else:
            outs = [sweep.cost_volume(ref_feature[b], view_features[:, b], homographies[:, b],
                                      row_offset=row_offset) for b in range(B)]
        return torch.stack(outs, dim=0)

    @staticmethod
    def backward(ctx, g):
        ref, views, homs = ctx.saved_tensors
        grads = [cost_volume_backward(ref[b], views[:, b], homs[:, b], g[b], ctx.row_offset)
                 for b in range(ref.shape[0])]
        d_ref = torch.stack([r for r, _ in grads], dim=0)
        d_views = torch.stack([v for _, v in grads], dim=1)
        return d_ref, d_views, None, None


def plane_sweep_cost_volume(ref_feature, view_features, homographies, depth_chunk: int = 0,
                            fill_mode: str = "zeros", out_dtype=None, use_pallas: bool = True,
                            differentiable: bool = False, cw_out: bool = False):
    """ref_feature (B, h, w, C), view_features (V-1, B, h, w, C),
    homographies (V-1, B, D, 3, 3) -> (B, D, h, w, C), with JAX's
    parameters in JAX's order (mvsnet_tpu/ops/cost_volume.py:95).

    `depth_chunk` and `use_pallas` are accepted and have no effect: the
    port picks its chunks and its kernel by the tensors' device.
    `fill_mode="zeros"` is K1 on CUDA tensors (a `CostVolumeFn` when
    `differentiable`); "edge" is the plain edge-clamped warp plane by plane
    (`cost_slice`, autograd through PyTorch), as JAX's Pallas path too is
    for zeros only. The volume comes in the features' dtype unless
    `out_dtype` is given; `cw_out` returns the (B, D, h, C, w) permutation."""
    del depth_chunk, use_pallas
    if fill_mode == "edge":
        D = homographies.shape[2]
        out = torch.stack([cost_slice(ref_feature, view_features, homographies[:, :, d], "edge")
                           for d in range(D)], dim=1).to(out_dtype or ref_feature.dtype)
    elif fill_mode != "zeros":
        raise ValueError(f"unknown fill_mode {fill_mode!r} (zeros or edge)")
    elif differentiable:
        out = CostVolumeFn.apply(ref_feature, view_features, homographies)
    else:
        B = ref_feature.shape[0]
        outs = [_cost_one(ref_feature[b], view_features[:, b], homographies[:, b])
                for b in range(B)]
        out = outs[0][None] if B == 1 else torch.stack(outs, dim=0)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out.transpose(-1, -2) if cw_out else out


def sweep_cost_volume_sharded(ref_l, views_l, homographies, mesh, depth=None, rows=None):
    """This rank's block of the cost volume (counterpart of
    `pallas_sweep_cost_volume_sharded`, mvsnet_tpu/ops/pallas/sweep.py:1986).

    ref_l (B, hl, w, C) and views_l (V-1, B, hl, w, C) are the rank's row
    block; homographies (V-1, B, D, 3, 3) are whole. `depth` and `rows`
    (`parallel.mesh.AxisSplit`s over 'depth' and 'space') say which planes
    and rows the block holds; by default the even split over the mesh's
    axes (rows [s * hl, (s + 1) * hl), s the 'space' index). The source
    views are all-gathered over 'space', the homographies cut to the depth
    slab, and K1s runs per batch element with the block's row offset.
    Under autograd it is `CostVolumeFn` on the block (K2 and K3 with the
    row offset backward), and the gather's backward sums each rank's share
    of the views' gradient over 'space' and hands the owners their rows.
    Returns (B, Dl, hl, w, C) in the features' dtype; shapes K1s cannot
    take raise."""
    from mvsnet_tpu_torch.parallel.mesh import AxisSplit

    V1, B, D = homographies.shape[:3]
    hl = ref_l.shape[1]
    if views_l.shape[:2] != (V1, B) or views_l.shape[2:] != ref_l.shape[1:]:
        raise ValueError(f"views {tuple(views_l.shape)} do not match ref {tuple(ref_l.shape)} "
                         f"and homographies {tuple(homographies.shape)}")
    if depth is None:
        dp = mesh.axis_size("depth")
        if D % dp:
            raise ValueError(f"{D} depth planes do not split over {dp} 'depth' ranks")
        depth = AxisSplit("depth", D, dp, mesh.axis_index("depth"))
    if rows is None:
        sp = mesh.axis_size("space")
        rows = AxisSplit("space", hl * sp, sp, mesh.axis_index("space"))
    (d0, d1), (r0, r1) = depth.bounds(), rows.bounds()
    if r1 - r0 != hl or depth.size != D:
        raise ValueError(f"a block of {hl} rows and {D} planes for {rows} and {depth}")
    views = mesh.all_gather_grad(views_l, "space", dim=2) if rows.n > 1 else views_l
    homs = homographies[:, :, d0:d1]
    if torch.is_grad_enabled() and (ref_l.requires_grad or views_l.requires_grad):
        return CostVolumeFn.apply(ref_l, views, homs, r0)
    return torch.stack([sweep.cost_volume(ref_l[b], views[:, b], homs[:, b], row_offset=r0)
                        for b in range(B)], dim=0)


def pixel_cost_volume(ref_feature, view_features, planes, projections):
    """ref_feature (B, h, w, C), view_features (V-1, B, h, w, C), planes
    (B, D, h, w) float32, each pixel's plane depths, or (B, D), one depth a
    plane; projections (V-1, B, 3, 4) float32, each source view's [M | b]
    (`geometry.pixel_projections`) -> (B, D, h, w, C) in the features'
    dtype: the variance over the views of each view sampled at q = d M (x +
    0.5, y + 0.5, 1) + b, the reference view included, float32 sums."""
    outs = [sweep.pixel_cost_volume(ref_feature[b], view_features[:, b], planes[b],
                                    projections[:, b]) for b in range(ref_feature.shape[0])]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs, dim=0)


def cost_slice(ref_feature, view_features, homographies_d, fill_mode: str = "zeros"):
    """Single-depth-plane variance cost: ref_feature (B, h, w, C),
    view_features (V-1, B, h, w, C), homographies_d (V-1, B, 3, 3) at one
    depth -> (B, h, w, C) float32; each view warped in its dtype
    (`homography_warp`), then the sums in float32 with the reference view
    included."""
    ref32 = ref_feature.to(torch.float32)
    s, s2 = ref32, ref32 * ref32
    for feat, homs in zip(view_features, homographies_d):
        warped = homography_warp(feat, homs, fill_mode).to(torch.float32)
        s, s2 = s + warped, s2 + warped * warped
    view_num = view_features.shape[0] + 1
    mean = s / view_num
    return s2 / view_num - mean * mean
