"""Model, training and data configuration (counterpart of
mvsnet_tpu/config.py), and `config.json` files.

A copy, not an import: the JAX package's config imports `jax.numpy`. Field
names and defaults are JAX's, so a `config.json` written by either package
loads in the other: the port reads JAX's files and drops the TPU knobs it
has no use for (`JAX_ONLY_FIELDS`); JAX reads the port's, which lack only
those knobs, with their defaults.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

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
    """Static model hyperparameters; field names and defaults match the JAX
    `ModelConfig` (reference: train.py:53-90). `view_num`, `width` and
    `height` describe the operating point: the graph takes its shapes from
    its inputs. The refinement options build and drive the 3D-CNN graph's
    refinement network (`models/refine.py`, `MVSNet.refine`); the JAX TPU
    knobs (`depth_chunk`, `use_pallas`) are not copied."""

    view_num: int = 3
    max_d: int = 192
    width: int = 640
    height: int = 480
    sample_scale: float = 0.25        # cost volume resolution vs input
    interval_scale: float = 1.0
    base_image_size: int = 8
    inverse_depth: bool = False
    regularization: str = "3DCNN"     # "3DCNN" | "GRU"
    network_mode: str = "normal"
    refinement: bool = False
    refinement_network: str = "original"   # "original" | "unet"
    upsample_before_refinement: bool = True
    refine_with_confidence: bool = False
    refine_with_stereo: bool = False
    residual_refinement: bool = True
    prob_num_buckets: int = 4
    compute_dtype: str = "bfloat16"   # conv compute dtype; params stay f32

    @property
    def base_divisor(self) -> float:
        return base_divisor(self.network_mode)

    @property
    def feature_channels(self) -> int:
        """Output channels of the feature tower = 4 * scaled base filter 8."""
        return scaled_filters(8, self.network_mode) * 4

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def feature_height(self) -> int:
        return int(self.height * self.sample_scale)

    @property
    def feature_width(self) -> int:
        return int(self.width * self.sample_scale)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters; field names and defaults match the JAX
    `TrainConfig` (mvsnet_tpu/config.py:99-122, reference: train.py:92-135).
    `num_devices` is the number of ranks (`train.py`). `remat` is read
    nowhere, as in JAX: R-MVSNet's training sweep recomputes each depth step
    in the backward pass whatever it says (`models/mvsnet.GRUSweep.remat`),
    and the cost volume's backward recomputes its warps
    (`ops/cost_volume.CostVolumeFn`)."""

    batch_size: int = 1
    epoch: int = 1
    max_steps_per_epoch: Optional[int] = None
    base_lr: float = 1e-3
    stepvalue: int = 70000            # lr decay interval (exponential, continuous)
    gamma: float = 0.5                # lr decay rate
    snapshot: int = 5000              # checkpoint every N steps
    optimizer: str = "rmsprop"        # "rmsprop" | "momentum" | "adam"
    loss_type: str = "power"          # "original" | "power" | "gaussian"
    alpha: float = 0.25
    beta: float = 0.0
    eta: float = 0.02
    grad_loss: bool = True
    refinement_train_mode: str = "all"   # "all" | "refine_only" | "main_only"
    val_batch_size: int = 100
    train_steps_per_val: int = 500
    seed: int = 0
    num_devices: Optional[int] = None    # None = the ranks of the process group
    remat: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data-plane parameters (mvsnet_tpu/config.py:125-142, reference:
    cluster_generator.py:28-56)."""

    data_dir: str = ""
    view_num: int = 3
    image_width: int = 640
    image_height: int = 480
    depth_num: int = 192
    interval_scale: float = 1.0
    base_image_size: int = 8
    output_scale: float = 0.25
    flip_cams: bool = False
    sessions_frac: float = 1.0
    max_clusters_per_session: Optional[int] = None
    include_empty: bool = False
    clear_cache: bool = False
    prefetch: int = 2


# fields of the JAX configs with no counterpart here, dropped on load
JAX_ONLY_FIELDS = {"model": {"depth_chunk", "use_pallas"}, "train": set(), "data": set()}
_CONFIGS = (("model", ModelConfig), ("train", TrainConfig), ("data", DataConfig))


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def save_config(path: str, **configs) -> None:
    """`config.json` as JAX's `save_config` writes it: {"model": {...},
    "train": {...}, "data": {...}}."""
    with open(path, "w") as f:
        json.dump({k: _to_jsonable(v) for k, v in configs.items()}, f, indent=2)


def load_config(path: str) -> dict:
    """The configs of a `config.json` from either package; an unknown field
    raises, as in JAX."""
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for key, cls in _CONFIGS:
        if key in raw:
            fields = {k: v for k, v in raw[key].items() if k not in JAX_ONLY_FIELDS[key]}
            out[key] = cls(**fields)
    return out
