"""The port's hand-written CUDA kernels, one module per source, with their
plain PyTorch versions and launch counts."""

from __future__ import annotations

from mvsnet_tpu_torch.ops.kernels import conv, deconv, sweep, warp, wgrad

# kernel name -> (module, name of its launch counter)
COUNTERS = {
    "cost_volume": (sweep, "launches"),
    "cost_volume_sharded": (sweep, "launches_sharded"),
    "conv": (conv, "launches"),
    "deconv": (deconv, "launches"),
    "warp": (warp, "launches"),
    "warp_transpose": (warp, "transpose_launches"),
    "wgrad": (wgrad, "launches"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
