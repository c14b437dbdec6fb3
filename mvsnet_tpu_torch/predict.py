"""3D-CNN prediction on one device or over a mesh (counterpart of the
3D-CNN branches of mvsnet_tpu/predict.py:51-170, the multi-device one at
:94-108).

Weights come from a seed, from `convert.state_dict_from_jax`, or from a
checkpoint of the port (`checkpoint.restore_tree(...)["model"]`; a JAX
checkpoint converts with `tools/jax_ckpt_to_torch.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mvsnet_tpu_torch import resolve_device
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn
from mvsnet_tpu_torch.parallel.infer_step import make_sharded_forward, make_sharded_gru_forward
from mvsnet_tpu_torch.parallel.mesh import factorize_devices, make_mesh


def _default_mesh(device):
    """Inside a process group of more than one rank: JAX's serving mesh
    (1, data * depth, space) from `factorize_devices(world)` (inference
    batches are tiny, so the data axis stays 1). Gloo ranks stage CUDA
    tensors through the host unless the CPU is asked for."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    da, de, sp = factorize_devices(dist.get_world_size())
    if dist.get_backend() == "nccl":
        backend = "nccl"
    else:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "gloo-cuda"
    return make_mesh(shape=(1, da * de, sp), backend=backend)


class Predictor:
    """Eval MVSNet. On one device `device=None` is `cuda:0` and raises
    without CUDA; `device="cpu"` runs the plain path. Over a mesh of more
    than one rank (`mesh`, or by default inside a process group, every
    rank constructing its own Predictor with the same arguments and calling
    `predict` with the same inputs) `device=None` is the rank's own device,
    which must be a card; the forward is `make_sharded_forward`'s, or for
    the GRU `make_sharded_gru_forward`'s (the maps split over the ranks)."""

    def __init__(self, mcfg: ModelConfig, state_dict: Optional[dict] = None,
                 seed: int = 0, device=None, mesh=None):
        if mcfg.refinement:
            raise NotImplementedError("refinement is not ported yet")
        self.mcfg = mcfg
        self.mesh = mesh if mesh is not None else _default_mesh(device)
        if self.mesh is not None and self.mesh.size > 1:
            if device is None and self.mesh.device.type != "cuda":
                raise RuntimeError("device=None runs on the rank's card, and this mesh "
                                   f"puts the rank on {self.mesh.device}; pass "
                                   "device='cpu' to run the plain path")
            self.device = self.mesh.device if device is None else resolve_device(device)
            if self.device != self.mesh.device:
                raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
        else:
            self.mesh = None
            self.device = resolve_device(device)
        model = MVSNet(mcfg, seed=seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        # forward(images, cams, depth_start, depth_interval, depth_end)
        if mcfg.regularization == "GRU":
            gru = (make_sharded_gru_forward(self.model, self.mesh) if self.mesh is not None
                   else lambda im, ca, ds, de: self.model.forward_gru_wta(im, ca, ds, None, de))

            def forward(images, cams, ds, di, de):
                depth, prob = gru(images, cams, ds, de)
                return depth, prob, torch.zeros_like(depth)
            self._forward = forward
        elif self.mesh is not None:
            sharded = make_sharded_forward(self.model, self.mesh)
            self._forward = lambda im, ca, ds, di, de: sharded(im, ca, ds, di)
        else:
            self._forward = lambda im, ca, ds, di, de: apply_forward_3dcnn(
                self.model, im, ca, ds, di)

    def _tensor(self, a):
        if not torch.is_tensor(a):
            a = np.array(a, dtype=np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def predict(self, images, cams, depth_start, depth_interval, depth_end,
                fetch: bool = True):
        """(depth_map, prob_map, residual), each (B, h, w, 1). fetch=True
        returns numpy arrays after the device finishes; fetch=False returns
        the device tensors as soon as the work is queued. As in JAX
        (mvsnet_tpu/predict.py:110-139), the 3D-CNN graph reads
        `depth_interval` and not `depth_end`, the GRU graph `depth_end` and
        not `depth_interval`."""
        out = self._forward(self._tensor(images), self._tensor(cams),
                            self._tensor(depth_start), self._tensor(depth_interval),
                            self._tensor(depth_end))
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
