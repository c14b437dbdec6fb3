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
"""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.ops.kernels import sweep, warp

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


def cost_volume_backward(ref, views, homs, g):
    """Gradients of one batch element's cost volume (sweep.py:1793-1841):

      d_ref    = (2/V) sum_d (ref - mean_d) g_d
      d_view_v = warp_v^T ((2/V) (w_vd - mean_d) g_d)

    ref (h, w, C), views (V-1, h, w, C), homs (V-1, D, 3, 3), g (D, h, w,
    C) -> d_ref in ref's dtype, d_views in views' dtype."""
    H, W, C = ref.shape
    V1, D = homs.shape[:2]
    V = V1 + 1
    g32 = g.to(torch.float32)
    ref32 = ref.to(torch.float32)
    n_chunks = max(1, -(-(V * D * H * W * C * 4) // ACC_LIMIT_BYTES))
    dc = -(-D // n_chunks)
    scale = 2.0 / V
    d_ref = torch.zeros((H, W, C), dtype=torch.float32, device=ref.device)
    d_views = [torch.zeros_like(d_ref) for _ in range(V1)]
    for c0 in range(0, D, dc):
        gd = g32[c0:c0 + dc]
        warped = [warp.warp_all_depths(views[v], homs[v, c0:c0 + dc]).to(torch.float32)
                  for v in range(V1)]
        mean = ref32[None]
        for w in warped:
            mean = mean + w
        mean = mean / V
        d_ref += scale * torch.sum((ref32[None] - mean) * gd, dim=0)
        for v in range(V1):
            cot = scale * (warped[v] - mean) * gd
            d_views[v] += warp.warp_transpose(cot, homs[v, c0:c0 + dc])
    return d_ref.to(ref.dtype), torch.stack(d_views).to(views.dtype)


class CostVolumeFn(torch.autograd.Function):
    """Differentiable cost volume; see the module docstring."""

    @staticmethod
    def forward(ctx, ref_feature, view_features, homographies):
        ctx.save_for_backward(ref_feature, view_features, homographies)
        B = ref_feature.shape[0]
        return torch.stack([_cost_one(ref_feature[b], view_features[:, b],
                                      homographies[:, b]) for b in range(B)], dim=0)

    @staticmethod
    def backward(ctx, g):
        ref, views, homs = ctx.saved_tensors
        grads = [cost_volume_backward(ref[b], views[:, b], homs[:, b], g[b])
                 for b in range(ref.shape[0])]
        d_ref = torch.stack([r for r, _ in grads], dim=0)
        d_views = torch.stack([v for _, v in grads], dim=1)
        return d_ref, d_views, None


def plane_sweep_cost_volume(ref_feature, view_features, homographies,
                            differentiable: bool = False):
    """ref_feature (B, h, w, C), view_features (V-1, B, h, w, C),
    homographies (V-1, B, D, 3, 3) -> (B, D, h, w, C) in the features'
    dtype. `differentiable` makes the volume a `CostVolumeFn`."""
    if differentiable:
        return CostVolumeFn.apply(ref_feature, view_features, homographies)
    B = ref_feature.shape[0]
    outs = [_cost_one(ref_feature[b], view_features[:, b], homographies[:, b])
            for b in range(B)]
    return outs[0][None] if B == 1 else torch.stack(outs, dim=0)
