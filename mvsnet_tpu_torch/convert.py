"""JAX variables -> the port's state dict.

The input is what `MVSNet.init` returns in the JAX package, as nested dicts
of numpy arrays: {"params": ..., "batch_stats": ...}. The port keeps flax's
names and layouts (HWIO/DHWIO conv kernels, flax-oriented transposed-conv
kernels, (in, out) dense kernels), so conversion drops the flax wrapper
levels `Conv_0`, `ConvTranspose_0`, `BatchNorm_0` and `Dense_0` (an `Fc`'s)
and joins the path with dots, e.g.
  params/feature_net/2dconv1_0/conv/Conv_0/kernel -> feature_net.2dconv1_0.conv.kernel
  batch_stats/regnet/3dconv1_0/bn/BatchNorm_0/mean -> regnet.3dconv1_0.bn.mean
"""

from __future__ import annotations

import numpy as np
import torch

_FLAX_WRAPPERS = {"Conv_0", "ConvTranspose_0", "BatchNorm_0", "Dense_0"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_jax(variables) -> dict:
    """{"params": tree, "batch_stats": tree} of arrays -> {name: float32 tensor}."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection) or {}):
            name = ".".join(p for p in path if p not in _FLAX_WRAPPERS)
            if name in out:
                raise ValueError(f"two JAX variables map to {name}")
            out[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out
