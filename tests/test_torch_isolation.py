"""The port stands alone: it imports neither JAX nor the JAX package, and
it does not quietly leave the card for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mvsnet_tpu_torch import resolve_device
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.predict import Predictor

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mvsnet_tpu"}

_PROBE = """
import importlib, pkgutil, sys
import numpy as np
import mvsnet_tpu_torch
for m in pkgutil.walk_packages(mvsnet_tpu_torch.__path__, "mvsnet_tpu_torch."):
    importlib.import_module(m.name)
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.predict import Predictor
cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64,
                  network_mode="ultralite", compute_dtype="float32")
rng = np.random.default_rng(0)
cam = np.zeros((2, 4, 4)); cam[0] = np.eye(4)
cam[1, :3, :3] = [[15, 0, 8], [0, 15, 8], [0, 0, 1]]
depth, prob, _ = Predictor(cfg, device="cpu").predict(
    rng.standard_normal((1, 3, 64, 64, 3)), np.stack([cam] * 3)[None], [5.0], [0.5], [8.5])
assert np.isfinite(depth).all()
print(sorted(m for m in sys.modules if m.split(".")[0] in %r))
"""


def test_import_and_cpu_forward_load_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE % (FORBIDDEN,)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in (ROOT / "mvsnet_tpu_torch").rglob("*.py")]
    + [Path("chip_smoke.py")]), ids=str)
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_default_device_needs_cuda(monkeypatch):
    """device=None means the card: without CUDA it raises, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(ModelConfig(network_mode="ultralite", max_d=8, width=64, height=64))
    assert resolve_device("cpu") == torch.device("cpu")
