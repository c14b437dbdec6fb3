"""Import reference TensorFlow checkpoints into the port's state dicts
(counterpart of mvsnet_tpu/tf_import.py).

The reference ships TF1 Saver checkpoints (reference: train.py:446,
utils.py:75-95; README.md:43-49 points at trained GCS models). This module
maps those variables onto the port's state-dict names (`convert.py`'s:
flax's module path joined with dots, the wrappers `Conv_0`,
`ConvTranspose_0` and `BatchNorm_0` dropped), so reference-trained weights
serve through `Predictor`, `test.main` and `infer.main`.

Name mapping. The reference builds every network in the default variable
scope, so TF names are exactly the layer names the port mirrors
(cnn_wrapper/mvsnetworks.py:53-158; convgru.py:82-121):

  TF variable                      state-dict name
  <layer>/kernel               ->  <net>.<layer>.conv.kernel
                                   (deconv: <net>.<layer>.deconv.kernel,
                                    transposed, see below; bare convs:
                                    <net>.<layer>.kernel)
  <layer>/bias                 ->  ... .bias
  <layer>/gn/gamma|beta        ->  <net>.<layer>.gn.scale|bias
  <layer>/bn/gamma|beta        ->  <net>.<layer>.bn.scale|bias
  <layer>/bn/moving_mean|variance -> <net>.<layer>.bn.mean|var

Layout transforms: tf.layers.conv2d/conv3d kernels are (spatial..., in,
out), the port's layout. tf.layers.conv2d_transpose/conv3d_transpose
kernels are (spatial..., OUT, IN) and swap their last two axes. A
transposed conv is known by its `deconv` scope; the bare transposed convs
of the refinement U-Net (`2dconv5_0_refine`, ...) have none, and are known
by their module's type (`transposed_kernels(model)`) where JAX sees flax's
`ConvTranspose_0` in the path.

GRU naming (reference convgru.py:84-121): each ConvGRUCell lives in scope
`conv_gru<i>` with `Gates/conv/{kernel,bias}` and
`Output/output_conv/{kernel,bias}`. The per-gate norms depend on the group
arithmetic (convgru.py:24-35, group_channel=16): true group norm creates
`<scope>/{reset,update,output}_norm/gn/{gamma,beta}`, but at the standard
GRU widths (16/4/2 filters) G collapses to 1 and tf.contrib's layer_norm
is used instead, variables `Gates/LayerNorm[_1]/{gamma,beta}` (reset
first, update second) and `Output/LayerNorm/...`; G >= C would give
`InstanceNorm`. The importer tries all three spellings.

An imported model dir holds the weights and batch-norm statistics only
(as JAX's import saves params and batch stats): it serves, but training
does not resume from it.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Callable, Collection, Dict, Tuple

import numpy as np
import torch

logger = logging.getLogger("mvsnet_tpu_torch.tf_import")

# top-level module names that do not exist as TF scopes
_NET_WRAPPERS = {"feature_net", "regnet", "refine_net", "gru_sweep", "gru"}
# optimizer slots and counters a Saver checkpoint carries beside the weights
_OPTIMIZER_VARS = ("Adam", "RMSProp", "Momentum", "global_step", "beta1_power",
                   "beta2_power")


def _identity(x):
    return x


def _swap_io(k):
    """TF conv*_transpose kernel (spatial..., out, in) -> the port's (..., in, out)."""
    return np.swapaxes(k, -1, -2)


def tf_name_candidates(name: str, transposed: bool = False) -> Tuple[list, Callable]:
    """Map one state-dict name to candidate TF variable names (tried in
    order) and a layout transform, as `flax_path_to_tf_name`
    (mvsnet_tpu/tf_import.py:59) maps the matching flax path. `transposed`
    marks the parameters of a transposed conv outside a `deconv` scope."""
    parts = name.split(".")
    leaf = parts.pop()
    parts = [p for p in parts if p not in _NET_WRAPPERS]

    # GRU cells (reference convgru.py:82-121)
    if parts and parts[0].startswith("conv_gru"):
        cell = parts[0]
        inner = parts[1] if len(parts) > 1 else ""
        if inner == "gates_conv":
            return [f"{cell}/Gates/conv/{leaf}"], _identity
        if inner == "output_conv":
            return [f"{cell}/Output/output_conv/{leaf}"], _identity
        gn_leaf = {"scale": "gamma", "bias": "beta"}[leaf]
        gn_name, ln_name = {
            "reset_norm": ("Gates/reset_norm", "Gates/LayerNorm"),
            "update_norm": ("Gates/update_norm", "Gates/LayerNorm_1"),
            "output_norm": ("Output/output_norm", "Output/LayerNorm"),
        }[inner]
        return [f"{cell}/{gn_name}/gn/{gn_leaf}",
                f"{cell}/{ln_name}/{gn_leaf}",
                f"{cell}/{gn_name.rsplit('/', 1)[0]}/InstanceNorm/{gn_leaf}"], _identity
    if parts and parts[0] == "prob_conv":
        return [f"prob_conv/{leaf}"], _identity

    layer = parts[0] if parts else ""
    inner = parts[1:]
    if "gn" in inner:
        return [f"{layer}/gn/{ {'scale': 'gamma', 'bias': 'beta'}[leaf]}"], _identity
    if "bn" in inner:
        bn_leaf = {"mean": "moving_mean", "var": "moving_variance",
                   "scale": "gamma", "bias": "beta"}[leaf]
        return [f"{layer}/bn/{bn_leaf}"], _identity
    if (transposed or "deconv" in inner) and leaf == "kernel":
        return [f"{layer}/{leaf}"], _swap_io
    return [f"{layer}/{leaf}"], _identity


def transposed_kernels(model: torch.nn.Module) -> frozenset:
    """State-dict names of the transposed convs' parameters in `model`."""
    from mvsnet_tpu_torch.models.layers import Deconv

    return frozenset(f"{prefix}.{leaf}" for prefix, m in model.named_modules()
                     if isinstance(m, Deconv) for leaf in ("kernel", "bias"))


def import_tf_vars(var_dict: Dict[str, np.ndarray], template, strict: bool = True,
                   transposed: Collection[str] = ()) -> dict:
    """Copy TF variables into a state dict.

    Args:
      var_dict: {tf_variable_name: numpy array}, from load_tf_checkpoint or
        an .npz export.
      template: the model, or a state dict (`model.state_dict()`), giving
        names, shapes and dtypes.
      strict: raise on any template entry missing from var_dict; otherwise
        keep the template's value and warn.
      transposed: with a state dict, the names of transposed-conv
        parameters outside a `deconv` scope (`transposed_kernels(model)`);
        a model gives them itself.
    Returns a new state dict of CPU tensors.
    """
    if isinstance(template, torch.nn.Module):
        transposed = transposed_kernels(template)
        template = template.state_dict()
    used, missing, out = set(), [], {}
    for name, leaf in template.items():
        candidates, transform = tf_name_candidates(name, name in transposed)
        tf_name = next((c for c in candidates if c in var_dict), None)
        if tf_name is None:
            missing.append((name, candidates))
            out[name] = leaf.detach().cpu().clone()
            continue
        val = transform(np.asarray(var_dict[tf_name]))
        if tuple(val.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {tf_name}: checkpoint {val.shape} "
                             f"vs model {tuple(leaf.shape)}")
        out[name] = torch.from_numpy(np.array(val, order="C")).to(leaf.dtype)
        used.add(tf_name)
    if missing:
        msg = f"{len(missing)} model entries not found in the TF checkpoint: {missing[:5]}..."
        if strict:
            raise KeyError(msg)
        logger.warning(msg)
    unused = {u for u in set(var_dict) - used if not any(s in u for s in _OPTIMIZER_VARS)}
    if unused:
        logger.warning("%d checkpoint variables unused by the model: %s...",
                       len(unused), sorted(unused)[:5])
    return out


def export_tf_vars(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's state dict under the reference's TF names and layouts
    (`import_tf_vars`' inverse): transposed-conv kernels (..., out, in), a
    GRU norm under the spelling its group count gives (layer norm for one
    group, instance norm for one channel a group, group norm otherwise)."""
    from mvsnet_tpu_torch.models.layers import GroupNormFlexible

    transposed = transposed_kernels(model)
    spelling = {}
    for prefix, m in model.named_modules():
        if isinstance(m, GroupNormFlexible):
            C = m.scale.shape[0]
            spelling[prefix] = 1 if m.groups == 1 else 2 if m.groups >= C else 0
    out = {}
    for name, value in model.state_dict().items():
        candidates, transform = tf_name_candidates(name, name in transposed)
        tf_name = candidates[spelling.get(name.rsplit(".", 1)[0], 0)]
        if tf_name in out:
            raise ValueError(f"two state-dict entries map to {tf_name}")
        out[tf_name] = np.ascontiguousarray(transform(value.detach().cpu().numpy()))
    return out


def load_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a TF checkpoint (Saver prefix or .npz export) into a dict.

    Saver V2 bundles (`<path>.index` + `<path>.data-*`) are read by the
    port's pure-numpy bundle reader (io/tf_bundle.py): no tensorflow
    needed. tensorflow, when present, is only a fallback for exotic
    variants the reader rejects (e.g. re-compressed index blocks,
    partitioned variables).
    """
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    from mvsnet_tpu_torch.io import tf_bundle

    if tf_bundle.is_bundle(path):
        try:
            return dict(tf_bundle.read_bundle(path))
        except ValueError as e:
            logger.warning("native bundle reader failed (%s); trying tensorflow", e)
    try:
        import tensorflow as tf
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            f"{path} is not a readable Saver V2 bundle or .npz export, "
            "and tensorflow is not installed for the fallback path; "
            "convert to .npz offline (np.savez(path, **{name: "
            "reader.get_tensor(name) for name in "
            "reader.get_variable_to_shape_map()}))") from e
    reader = tf.train.load_checkpoint(path)  # pragma: no cover
    return {name: reader.get_tensor(name)  # pragma: no cover
            for name in reader.get_variable_to_shape_map()}


def import_checkpoint(ckpt_path: str, model_dir: str, regularization: str = "3DCNN",
                      network_mode: str = "normal", strict: bool = True,
                      **model_options) -> str:
    """One call: TF checkpoint (Saver prefix or .npz) -> a model dir of the
    port that `Predictor(mcfg, model_dir, ckpt_step)`, `test.main` and
    `infer.main --model_dir` restore. Returns the checkpoint's directory.

    The template is `MVSNet(ModelConfig(regularization=..., network_mode=...,
    **model_options))`: its shapes do not depend on the operating point,
    so no forward is run. `model_options` are further `ModelConfig` fields
    that shape the model, e.g. refinement=True, refinement_network="unet",
    refine_with_confidence=True. The step is parsed from the reference's
    tf_model_<step>.ckpt convention when present (so --ckpt_step keeps
    meaning), else 0. The dir holds {"model": state_dict, "step": step}:
    no optimizer state, so training does not resume from it.
    """
    from mvsnet_tpu_torch import checkpoint
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet

    cfg = ModelConfig(regularization=regularization, network_mode=network_mode,
                      **model_options)
    state_dict = import_tf_vars(load_tf_checkpoint(ckpt_path), MVSNet(cfg), strict=strict)
    m = re.search(r"(\d+)", os.path.basename(ckpt_path))
    step = int(m.group(1)) if m else 0
    return checkpoint.save_tree(model_dir, regularization, network_mode, step,
                                {"model": state_dict, "step": step})
