"""MVSNet 3D-CNN graph (counterpart of mvsnet_tpu/models/mvsnet.py:71-190:
`apply_forward_3dcnn`, `MVSNet._extract_features`, `MVSNet.forward_3dcnn`).

Features of the V views run as one batch of B*V images; homographies in
float32; the fused cost volume (kernel K1); RegNetUS0; the fused
soft-argmin + probability tail. In training mode (`nn.Module.training`)
the cost volume is differentiable (`CostVolumeFn`) and the layers train
(`models/layers.py`). Refinement and the GRU graphs are not part of this
package yet.
"""

from __future__ import annotations

import torch
from torch import nn

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.models.feature_net import UNetDS2GN
from mvsnet_tpu_torch.models.layers import reset_parameters
from mvsnet_tpu_torch.models.regnet import RegNetUS0
from mvsnet_tpu_torch.ops.cost_volume import plane_sweep_cost_volume
from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map
from mvsnet_tpu_torch.ops.geometry import homographies_for_views


class MVSNet(nn.Module):
    """Feature tower + 3D regularizer, in eval mode until `.train()`.
    Weights are seeded with `seed` (lecun-normal kernels, identity norms)
    until a state dict from `convert.py` is loaded."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.feature_net = UNetDS2GN(cfg.network_mode, dtype=cfg.dtype)
        self.regnet = RegNetUS0(cfg.network_mode, cfg.feature_channels,
                                dtype=cfg.dtype)
        reset_parameters(self, seed)
        # built for inference; `train_lib.create_train_state` (or `.train()`)
        # switches to training mode, with batch statistics and autograd convs
        self.eval()

    def extract_features(self, images):
        """(B, V, H, W, 3) -> ref (B, h, w, C), views (V-1, B, h, w, C)."""
        B, V, H, W, _ = images.shape
        feats = self.feature_net(images.reshape(B * V, H, W, 3))
        h, w, C = feats.shape[1:]
        feats = feats.reshape(B, V, h, w, C)
        return feats[:, 0], feats[:, 1:].movedim(1, 0)

    def forward_3dcnn(self, images, cams, depth_start, depth_interval):
        """images (B, V, H, W, 3), view 0 the reference; cams (B, V, 2, 4, 4)
        scaled to the cost-volume resolution; depth_start, depth_interval
        (B,). Returns depth_map, prob_map, each (B, h, w, 1) float32."""
        cfg = self.cfg
        B = images.shape[0]
        dev = images.device
        depth_start = torch.as_tensor(depth_start, dtype=torch.float32,
                                      device=dev).expand(B)
        depth_interval = torch.as_tensor(depth_interval, dtype=torch.float32,
                                         device=dev).expand(B)
        depth_end = depth_start + (cfg.max_d - 1) * depth_interval

        ref_f, view_f = self.extract_features(images)
        fh, fw = ref_f.shape[1:3]
        # RegNetUS0's three halvings must stay even: (D, h, w) % 8 == 0.
        for dim, name in ((cfg.max_d, "max_d"), (fh, "feature height"),
                          (fw, "feature width")):
            if dim % 8 != 0:
                raise ValueError(
                    f"{name}={dim} must be divisible by 8 for the 3D U-Net "
                    f"regularizer (input H/W divisible by 32)")

        homs = homographies_for_views(cams, cfg.max_d, depth_start,
                                      depth_interval, depth_end,
                                      inverse_depth=cfg.inverse_depth)
        cost = plane_sweep_cost_volume(ref_f, view_f, homs,
                                       differentiable=self.training)
        reg = self.regnet(cost)[..., 0].to(torch.float32)          # (B, D, h, w)
        return soft_argmin_prob_map(reg, depth_start, depth_interval, cfg.max_d,
                                    inverse_depth=cfg.inverse_depth,
                                    depth_end=depth_end,
                                    num_buckets=cfg.prob_num_buckets)

    forward = forward_3dcnn


def apply_forward_3dcnn(model: MVSNet, images, cams, depth_start, depth_interval):
    """Eval 3D-CNN forward: (depth, prob, residual), residual zeros.
    Refinement is a later slice of the port and raises here."""
    if model.cfg.refinement:
        raise NotImplementedError("refinement is not ported yet")
    depth, prob = model.forward_3dcnn(images, cams, depth_start, depth_interval)
    return depth, prob, torch.zeros_like(depth)
