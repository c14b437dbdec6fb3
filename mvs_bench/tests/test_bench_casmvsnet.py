"""The `casmvsnet.serve` cell's own checks, as `test_bench_reference.py`,
`test_bench_control.py` and `test_bench_faults.py` make them for the other
cells: the plain reference against the port's CPU path (64x64, V=3, the
published 48/32/8 planes of D=192, float32), the float8 control failing
every compared number (at a small size on the CPU, and on the card at the
cell's size), and faults planted where the answer is produced that the
comparison must refuse."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mvs_bench import calibrate, generate, harness
from mvs_bench.reference import casmvsnet as ref
from mvs_bench.weights import make_weights

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
OP = {"height": 64, "width": 64, "max_d": 192, "interval_scale": 1.0, "view_num": 3}
MIX = {"pool": 2, "depth_interval_mm": 2.5, "depth_min_mm": 425.0, "depth_max_mm": 935.0,
       "rig": {"yaw_deg": [2.0, 6.0], "roll_deg": [0.0, 2.0], "baseline_mm": [40.0, 80.0]}}


def _model():
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import CasMVSNet

    cfg = ModelConfig(view_num=3, max_d=192, width=64, height=64, compute_dtype="float32",
                      cascade=True)
    return CasMVSNet(cfg)


def test_param_specs_are_the_port_state_dict():
    specs = {n: tuple(s) for n, s, _ in ref.param_specs({"base_filters": 8})}
    assert specs == {n: tuple(t.shape) for n, t in _model().state_dict().items()}


def test_forward_matches_port():
    w = make_weights(ref.param_specs({"base_filters": 8}), 13, "cpu")
    model = _model()
    model.load_state_dict(w)
    for images, cams, ds, di, _ in generate.serve_pool(MIX, OP, 7, "cpu"):
        t = [torch.as_tensor(a) for a in (images, cams, ds, di)]
        with torch.no_grad():
            depth, conf = model(*t)
            r_depth, _, _, r_conf = ref.forward(w, *t, 192)[-1]
        # depths in mm (~680): float32 sums in another order
        np.testing.assert_allclose(depth[..., 0].numpy(), r_depth.numpy(), rtol=0, atol=2e-3)
        np.testing.assert_allclose(conf[..., 0].numpy(), r_conf.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("at_size", [False, pytest.param(True, marks=pytest.mark.cuda)])
def test_control_fails_each_number(at_size, request):
    """The float8 control fails every compared number, not only one."""
    cell = harness.Cell(SPEC, "casmvsnet.serve")
    if at_size:
        device = request.getfixturevalue("card")
    else:
        device = torch.device("cpu")
        cell.op.update(height=128, width=160, max_d=16)
        cell.mix.update(pool=2)
    numbers = calibrate.control_numbers(cell, 2 ** 31 + 5, device)
    for k, limit in cell.limits.items():
        assert numbers[k] > limit, (k, numbers)


def _run(seed=2 ** 31 + 17):
    cell = harness.Cell(SPEC, "casmvsnet.serve")
    cell.op.update(height=64, width=64, max_d=8)
    cell.mix.update(pool=2, warmup_requests=1)
    out, _ = harness.run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter(),
                              {"compute_dtype": "float32"})
    return out


def test_stage_planes_without_the_upsample(monkeypatch):
    import mvsnet_tpu_torch.models.casmvsnet as m

    real = m.cascade_planes

    def tiled(depth, num, ratio, depth_min, depth_max, max_d, size):
        # the stage before's depth tiled to the stage's size, not resized
        if depth is not None:
            h, w = depth.shape[1:]
            depth = depth.repeat(1, size[0] // h, size[1] // w)
        return real(depth, num, ratio, depth_min, depth_max, max_d, size)
    monkeypatch.setattr(m, "cascade_planes", tiled)
    assert _run()["correct"] is False


def test_confidence_altered_where_produced(monkeypatch):
    import mvsnet_tpu_torch.models.casmvsnet as m

    real = m.cascade_regression

    def altered(cost, planes):
        depth, conf = real(cost, planes)
        return depth, conf * 0.9
    monkeypatch.setattr(m, "cascade_regression", altered)
    assert _run()["correct"] is False
