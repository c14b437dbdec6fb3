"""Checkpoint path conventions (a copy of mvsnet_tpu/utils/paths.py;
reference: mvsnet/utils.py:75-95).

Checkpoints live at <model_dir>/<regularization>/<network_mode>/<step>/,
the layout of the reference and of the JAX package. Remote (gs://,
memory://, ...) model dirs go through `io/filesystem`.
"""

from __future__ import annotations

import os

from mvsnet_tpu_torch.io import filesystem as fs


def mkdir_p(path: str) -> None:
    fs.makedirs(path, exist_ok=True)


def ckpt_dir(base_dir: str, regularization: str, network_mode: str, build: bool = False) -> str:
    if fs.is_remote(base_dir):
        path = fs.join(base_dir, regularization, network_mode)
    else:
        path = os.path.join(base_dir, regularization, network_mode)
    if build:
        mkdir_p(path)
    return path
