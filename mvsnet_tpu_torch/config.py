"""Model configuration (counterpart of mvsnet_tpu/config.py:17-96).

A copy, not an import: the JAX package's config imports `jax.numpy`.
"""

from __future__ import annotations

import dataclasses

import torch

# Width divisors per network mode (reference: cnn_wrapper/network.py:75-85).
NETWORK_MODE_DIVISORS = {
    "normal": 1.0,
    "semilite": 4.0 / 3.0,
    "lite": 2.0,
    "ultralite": 4.0,
    "fat": 0.5,
    "ultrafat": 0.25,
}

# The compute dtypes the port's kernels take.
_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def base_divisor(network_mode: str) -> float:
    try:
        return NETWORK_MODE_DIVISORS[network_mode]
    except KeyError:
        raise ValueError(
            f"unknown network_mode {network_mode!r}; expected one of "
            f"{sorted(NETWORK_MODE_DIVISORS)}") from None


def scaled_filters(base: int, network_mode: str) -> int:
    """Filter-count scaling: max(1, int(base / divisor)), int() truncation
    and a floor at 1, so channel counts line up with the JAX checkpoints."""
    return max(1, int(base / base_divisor(network_mode)))


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {name!r}; expected one of "
                         f"{sorted(_TORCH_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters of the 3D-CNN inference graph; field
    names and defaults match the JAX `ModelConfig`. `view_num`, `width`
    and `height` describe the operating point: the graph takes its shapes
    from its inputs. The JAX config's refinement sub-options and TPU
    knobs (`depth_chunk`, `use_pallas`) are not copied: nothing here reads
    them."""

    view_num: int = 3
    max_d: int = 192
    width: int = 640
    height: int = 480
    inverse_depth: bool = False
    regularization: str = "3DCNN"
    network_mode: str = "normal"
    refinement: bool = False
    prob_num_buckets: int = 4
    compute_dtype: str = "bfloat16"

    @property
    def feature_channels(self) -> int:
        """Output channels of the feature tower = 4 * scaled base filter 8."""
        return scaled_filters(8, self.network_mode) * 4

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)
