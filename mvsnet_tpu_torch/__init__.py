"""mvsnet_tpu_torch: MVSNet 3D-CNN inference and training in PyTorch and CUDA.

A port of `mvsnet_tpu` for one NVIDIA H100 (sm_90a). The JAX package stays
the reference; this package imports `torch` and numpy only and keeps its own
copy of everything it needs. Public functions keep the JAX layouts:
channels-last NHWC / NDHWC tensors, (V-1, B, D, 3, 3) homographies and
(B, V, 2, 4, 4) cam tensors.

Entry points run on the card unless the caller asks for the CPU: `device=None`
resolves to `cuda:0` and raises where CUDA is absent. On the CPU every kernel
wrapper runs its plain PyTorch version; on a CUDA tensor it launches its
hand-written kernel (`csrc/`) or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda:0`, raising when CUDA is absent. Only an explicit
    CPU device runs the plain PyTorch path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mvsnet_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain path")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
