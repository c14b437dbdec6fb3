"""Plane-sweep variance cost volume (counterpart of the eval path of
mvsnet_tpu/ops/cost_volume.py:95-238).

  cost(d) = E_v[f_v(d)^2] - E_v[f_v(d)]^2, reference view included,

with float32 sums. On CUDA tensors each batch element is one launch of the
fused kernel K1, which never writes a warped view to memory. On CPU tensors
the plain version runs in depth chunks that keep its float32 sums under
2 GiB.
"""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.ops.kernels import sweep

ACC_LIMIT_BYTES = 2 * 1024 ** 3


def plane_sweep_cost_volume(ref_feature, view_features, homographies):
    """ref_feature (B, h, w, C), view_features (V-1, B, h, w, C),
    homographies (V-1, B, D, 3, 3) -> (B, D, h, w, C) in the features'
    dtype."""
    V1, B, D = homographies.shape[:3]
    H, W, C = ref_feature.shape[1:]
    if ref_feature.device.type == "cpu":
        n_chunks = max(1, -(-(D * H * W * C * 4) // ACC_LIMIT_BYTES))
        chunk = -(-D // n_chunks)
        outs = [torch.cat([sweep.cost_volume(ref_feature[b], view_features[:, b],
                                             homographies[:, b, c0:c0 + chunk])
                           for c0 in range(0, D, chunk)], dim=0)
                for b in range(B)]
    else:
        outs = [sweep.cost_volume(ref_feature[b], view_features[:, b],
                                  homographies[:, b]) for b in range(B)]
    return outs[0][None] if B == 1 else torch.stack(outs, dim=0)
