"""Checkpoint save and restore (counterpart of mvsnet_tpu/checkpoint.py,
without orbax).

A checkpoint is one `torch.save` of plain containers at
  <model_dir>/<regularization>/<network_mode>/<step>/checkpoint.pt
(the JAX package's layout, one directory a step, every step kept):
  {"model": the model's state dict (parameters and batch-norm running
             statistics, under `convert.py`'s names),
   "optimizer": `optimizer.state_dict()`,
   "step": the optimizer steps taken}.
It loads with `weights_only=True`. Remote model dirs (gs://, memory://,
...) are written in a local staging directory and mirrored through
`io/filesystem`, as the JAX package does. A JAX (orbax) checkpoint becomes
one of these with `tools/jax_ckpt_to_torch.py`, where JAX is installed.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch

from mvsnet_tpu_torch.io import filesystem as fs
from mvsnet_tpu_torch.utils.paths import ckpt_dir

FILE = "checkpoint.pt"


def _steps(path: str) -> list:
    if not fs.isdir(path):
        return []
    steps = []
    for name in fs.listdir(path):
        try:
            steps.append(int(name))
        except ValueError:
            continue
    return sorted(steps)


def _write(tree: dict, step_dir: str) -> None:
    """torch.save into step_dir, whole or not at all (a file renamed into
    place)."""
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, f".{FILE}.{os.getpid()}")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(step_dir, FILE))


def save_checkpoint(base_dir: str, regularization: str, network_mode: str,
                    step: int, state) -> str:
    """Save a `train_lib.TrainState`: model, optimizer state and
    `state.step` (the checkpoint's directory is named by `step`, which the
    driver counts in samples, as JAX's does). Returns the directory."""
    tree = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "step": int(state.step)}
    return save_tree(base_dir, regularization, network_mode, step, tree)


def save_tree(base_dir: str, regularization: str, network_mode: str, step: int,
              tree: dict) -> str:
    """Save `tree` as checkpoint `step`; returns the directory. A tree
    without "optimizer" (`tf_import.import_checkpoint`'s) serves but does
    not resume training."""
    path = ckpt_dir(base_dir, regularization, network_mode, build=True)
    if fs.is_remote(path):
        with tempfile.TemporaryDirectory() as tmp:
            _write(tree, tmp)
            fs.upload_tree(tmp, fs.join(path, str(step)))
        return fs.join(path, str(step))
    step_dir = os.path.join(path, str(step))
    _write(tree, step_dir)
    return step_dir


def latest_step(base_dir: str, regularization: str, network_mode: str) -> Optional[int]:
    steps = _steps(ckpt_dir(base_dir, regularization, network_mode))
    return steps[-1] if steps else None


def restore_tree(base_dir: str, regularization: str, network_mode: str,
                 step: Optional[int] = None) -> dict:
    """The checkpoint's containers ({"model", "optimizer", "step"}) on the
    CPU; `step=None` is the latest."""
    path = ckpt_dir(base_dir, regularization, network_mode)
    if step is None:
        step = latest_step(base_dir, regularization, network_mode)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    if fs.is_remote(path):
        with tempfile.TemporaryDirectory() as tmp:
            fs.download_tree(fs.join(path, str(step)), tmp)
            return torch.load(os.path.join(tmp, FILE), map_location="cpu", weights_only=True)
    return torch.load(os.path.join(path, str(step), FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(base_dir: str, regularization: str, network_mode: str, state,
                       step: Optional[int] = None):
    """Load a checkpoint into `state` (a `train_lib.TrainState` built for
    the same model and optimizer) in place and return it."""
    tree = restore_tree(base_dir, regularization, network_mode, step)
    if "optimizer" not in tree:
        raise ValueError(f"checkpoint {step} under {base_dir} holds model weights only (an "
                         "imported TF checkpoint): it serves, but training cannot resume from it")
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    return state
