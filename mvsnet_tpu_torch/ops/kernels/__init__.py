"""The port's hand-written CUDA kernels, one module each, with their plain
PyTorch versions and launch counts."""

from __future__ import annotations

from mvsnet_tpu_torch.ops.kernels import conv, deconv, sweep

MODULES = {"cost_volume": sweep, "conv": conv, "deconv": deconv}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in MODULES.items()}


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0
