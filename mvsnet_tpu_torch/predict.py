"""Single-device 3D-CNN prediction (counterpart of the single-device 3D-CNN
branch of mvsnet_tpu/predict.py:51-170).

Weights come from `convert.state_dict_from_jax` or from a seed. Restoring
an orbax checkpoint, the GRU branch and the multi-device paths wait for
later slices of the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mvsnet_tpu_torch import resolve_device
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn


class Predictor:
    """Eval MVSNet on one device: `device=None` is `cuda:0` and raises
    without CUDA; `device="cpu"` runs the plain path."""

    def __init__(self, mcfg: ModelConfig, state_dict: Optional[dict] = None,
                 seed: int = 0, device=None):
        if mcfg.regularization != "3DCNN":
            raise NotImplementedError("the GRU graphs are not ported yet")
        if mcfg.refinement:
            raise NotImplementedError("refinement is not ported yet")
        self.mcfg = mcfg
        self.device = resolve_device(device)
        model = MVSNet(mcfg, seed=seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    def _tensor(self, a):
        if not torch.is_tensor(a):
            a = np.array(a, dtype=np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def predict(self, images, cams, depth_start, depth_interval,
                fetch: bool = True):
        """(depth_map, prob_map, residual), each (B, h, w, 1). fetch=True
        returns numpy arrays after the device finishes; fetch=False returns
        the device tensors as soon as the work is queued."""
        out = apply_forward_3dcnn(self.model, self._tensor(images),
                                  self._tensor(cams), self._tensor(depth_start),
                                  self._tensor(depth_interval))
        if not fetch:
            return out
        return tuple(o.cpu().numpy() for o in out)


def depth_params_from_cams(scaled_cams):
    """depth_start, depth_interval, depth_num, depth_end from the scaled
    reference cam (reference: predictlib.py:182-199)."""
    depth_start = scaled_cams[:, 0, 1, 3, 0]
    depth_interval = scaled_cams[:, 0, 1, 3, 1]
    depth_num = int(scaled_cams[0, 0, 1, 3, 2])
    depth_end = scaled_cams[:, 0, 1, 3, 3]
    return depth_start, depth_interval, depth_num, depth_end
