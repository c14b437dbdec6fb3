"""The port's hand-written CUDA kernels, one module per source, with their
plain PyTorch versions and launch counts."""

from __future__ import annotations

from mvsnet_tpu_torch.ops.kernels import conv, deconv, sweep, warp, wgrad

# kernels with a tensor-core and a CUDA-core edition
EDITIONED = {"conv": conv, "deconv": deconv, "wgrad": wgrad}

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


def edition_counts() -> dict:
    """{kernel: {edition: launches}} of the kernels with two editions."""
    return {name: dict(mod.launches_by_edition) for name, mod in EDITIONED.items()}


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    for mod in EDITIONED.values():
        for e in mod.launches_by_edition:
            mod.launches_by_edition[e] = 0
