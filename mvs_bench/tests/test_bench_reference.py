"""The plain reference against the port's CPU path at 64x64, D=8, V=3,
float32, and the imports of the benchmark."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from mvs_bench import generate
from mvs_bench.reference import mvsnet as ref_mvsnet
from mvs_bench.reference import rmvsnet as ref_rmvsnet
from mvs_bench.weights import make_weights

BENCH = Path(__file__).resolve().parents[1]
OP = {"height": 64, "width": 64, "max_d": 8, "interval_scale": 1.0, "view_num": 3}
MIX = {"pool": 2, "depth_interval_mm": 2.5, "depth_min_mm": 425.0, "depth_max_mm": 935.0,
       "rig": {"yaw_deg": [2.0, 6.0], "roll_deg": [0.0, 2.0], "baseline_mm": [40.0, 80.0]}}


def _model(reg, weights):
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet

    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, regularization=reg,
                      compute_dtype="float32")
    model = MVSNet(cfg)
    model.load_state_dict(weights)
    return cfg, model


@pytest.mark.parametrize("reg,mod", [("3DCNN", ref_mvsnet), ("GRU", ref_rmvsnet)])
def test_param_specs_are_the_port_state_dict(reg, mod):
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet

    sd = MVSNet(ModelConfig(regularization=reg)).state_dict()
    specs = {n: tuple(s) for n, s, _ in mod.param_specs({"base_filters": 8})}
    assert specs == {n: tuple(t.shape) for n, t in sd.items()}


def test_mvsnet_forward_matches_port():
    from mvsnet_tpu_torch.models.mvsnet import apply_forward_3dcnn

    w = make_weights(ref_mvsnet.param_specs({"base_filters": 8}), 11, "cpu")
    _, model = _model("3DCNN", w)
    for images, cams, ds, di, _ in generate.serve_pool(MIX, OP, 5, "cpu"):
        t = [torch.as_tensor(a) for a in (images, cams, ds, di)]
        with torch.no_grad():
            depth, prob, _ = apply_forward_3dcnn(model, *t)
            r_depth, r_pvol, r_prob = ref_mvsnet.forward(w, *t, 8)
        np.testing.assert_allclose(depth[..., 0].numpy(), r_depth.numpy(), rtol=0, atol=2e-3)
        np.testing.assert_allclose(prob[..., 0].numpy(), r_prob.numpy(), rtol=0, atol=2e-4)


def test_rmvsnet_wta_matches_port():
    w = make_weights(ref_rmvsnet.param_specs({"base_filters": 8}), 12, "cpu")
    _, model = _model("GRU", w)
    for images, cams, ds, _, de in generate.serve_pool(MIX, OP, 6, "cpu"):
        t = [torch.as_tensor(a) for a in (images, cams, ds, de)]
        with torch.no_grad():
            depth, prob = model.forward_gru_wta(t[0], t[1], t[2], None, t[3])
            r_depth, r_prob, _ = ref_rmvsnet.wta(w, *t, 8)
        np.testing.assert_array_equal(depth[..., 0].numpy(), r_depth.numpy())
        np.testing.assert_allclose(prob[..., 0].numpy(), r_prob.numpy(), rtol=0, atol=1e-5)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "mvsnet_tpu"), (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "math", "numpy", "torch",
                                          "mvs_bench"), (path, name)
            if name.startswith("mvs_bench"):
                assert name.startswith("mvs_bench.reference"), (path, name)
