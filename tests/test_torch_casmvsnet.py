"""CasMVSNet on the port's CPU path (`models/casmvsnet.py`, the per-pixel
cost volume's plain edition, `Predictor`, the drivers) against the
benchmark's plain reference (`mvs_bench/reference/casmvsnet.py`), at
64x64, V=3 and the published 48/32/8 planes, float32, on two weight
seeds; its spans and counters per request; the reference's constants
against the configuration; the existing configurations' `config.json` as
JAX reads it.

Tolerances: float32 sums in another order (the port's channels-last convs
and gather warp against `F.conv*d` and `grid_sample`), relative to each
tensor's largest value; depths in mm (~680 here), where float32 resolves
6e-5 and the port forms the later stages' planes by one bilinear resize
where the reference resizes twice."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, os.path.dirname(__file__))
from synthetic_session import make_dataset, make_session  # noqa: E402

from mvs_bench import generate, harness  # noqa: E402
from mvs_bench.reference import casmvsnet as ref  # noqa: E402
from mvs_bench.weights import make_weights  # noqa: E402
from mvsnet_tpu import config as jax_config  # noqa: E402
from mvsnet_tpu_torch import infer  # noqa: E402
from mvsnet_tpu_torch import test as port_test  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, load_config, save_config  # noqa: E402
from mvsnet_tpu_torch.io.pfm import load_pfm  # noqa: E402
from mvsnet_tpu_torch.models import CasMVSNet, casmvsnet  # noqa: E402
from mvsnet_tpu_torch.ops.cost_volume import pixel_cost_volume  # noqa: E402
from mvsnet_tpu_torch.ops.geometry import cascade_planes, pixel_projections  # noqa: E402
from mvsnet_tpu_torch.predict import Predictor  # noqa: E402
from mvsnet_tpu_torch.utils import profiling  # noqa: E402

H = W = 64
D = 192
OP = {"height": H, "width": W, "max_d": D, "interval_scale": 1.06, "view_num": 3}
MIX = {"pool": 1, "depth_interval_mm": 2.5, "depth_min_mm": 425.0, "depth_max_mm": 935.0,
       "rig": {"yaw_deg": [2.0, 6.0], "roll_deg": [0.0, 2.0], "baseline_mm": [40.0, 80.0]}}


def _cfg():
    return ModelConfig(view_num=3, max_d=D, width=W, height=H, compute_dtype="float32",
                       cascade=True)


def _close(got, want, rel):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = (got - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


@pytest.fixture(scope="module", params=[11, 12])
def case(request):
    """Seeded weights, the port's model holding them, one request and the
    reference's stages on it."""
    w = make_weights(ref.param_specs({"base_filters": 8}), request.param, "cpu")
    model = CasMVSNet(_cfg())
    model.load_state_dict(w)
    images, cams, ds, di, de = generate.serve_pool(MIX, OP, request.param, "cpu")[0]
    t = [torch.as_tensor(a) for a in (images, cams, ds, di)]
    with torch.no_grad():
        stages = ref.forward(w, *t, D)
        feats = ref.fpn(w, t[0].reshape(3, H, W, 3).permute(0, 3, 1, 2))
    return dict(w=w, model=model, request=(images, cams, ds, di, de), t=t, stages=stages,
                feats=feats)


def test_fpn_levels_match_reference(case):
    with torch.no_grad():
        got = case["model"].feature_net(case["t"][0].reshape(3, H, W, 3))
    for g, want in zip(got, case["feats"]):
        _close(g, want.permute(0, 2, 3, 1), 1e-4)


def test_stage_planes_match_reference(case):
    _, _, ds, di = case["t"]
    de = ds + (D - 1) * di
    depth = None
    for s, (num, ratio) in enumerate(zip(casmvsnet.PLANES, casmvsnet.INTERVAL_RATIOS)):
        want = ref.stage_planes(depth, s, ds, di, D, H, W)
        got = cascade_planes(depth, num, ratio, ds, de, D, want.shape[2:])
        if depth is None:
            got = got[:, :, None, None].expand_as(want)
        _close(got, want, 3e-6)     # 2e-3 mm at ~680 mm
        depth = case["stages"][s][0]


def test_pixel_cost_volume_plain_matches_reference(case):
    _, cams, ds, di = case["t"]
    for s, f in enumerate(case["feats"]):
        proj = pixel_projections(cams, 2.0 ** s)
        _close(proj, ref.projections(cams, s), 1e-5)
        planes = case["stages"][s][2]
        f = f[:, None]                                                 # (V, B, C, h, w)
        want = ref.cost_volume(f[0], list(f[1:]), proj, planes)        # (B, C, D, h, w)
        cl = f.permute(0, 1, 3, 4, 2)
        got = pixel_cost_volume(cl[0], cl[1:], planes, proj)
        _close(got, want.permute(0, 2, 3, 4, 1), 1e-4)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_costregnet_matches_reference(case, stage):
    C = (32, 16, 8)[stage]
    Ds, h = (48, 32, 8)[stage], H >> (2 - stage)
    volume = torch.randn((1, C, Ds, h, h), generator=torch.Generator().manual_seed(stage))
    with torch.no_grad():
        got = case["model"].regnet(volume.permute(0, 2, 3, 4, 1), stage)[..., 0]
        want = ref.costregnet(case["w"], volume, stage)
    _close(got, want, 1e-4)


def test_predictor_matches_reference(case):
    depth, conf, residual = Predictor(_cfg(), state_dict=case["w"], device="cpu").predict(
        *case["request"])
    r_depth, _, _, r_conf = case["stages"][-1]
    assert depth.shape == conf.shape == residual.shape == (1, H, W, 1)
    _close(depth[..., 0], r_depth, 3e-6)
    _close(conf[..., 0], r_conf, 1e-4)
    assert not residual.any()


def test_spans_and_counters_per_request(case):
    predictor = Predictor(_cfg(), state_dict=case["w"], device="cpu")
    before, counts = profiling.traced(), profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        predictor.predict(*case["request"])
    after, counts_after = profiling.traced(), profiling.counters()

    def calls(name):
        return (after["spans"].get(name, {}).get("calls", 0)
                - before["spans"].get(name, {}).get("calls", 0))
    assert calls("mvsnet.predict") == calls("mvsnet.features") == 1
    for name in ("mvsnet.cascade.stage", "mvsnet.cascade.planes", "mvsnet.cost_volume",
                 "mvsnet.regularizer", "mvsnet.depth_tail"):
        assert calls(name) == 3, name
    planes = 48 * 16 * 16 + 32 * 32 * 32 + 8 * 64 * 64
    for source in ((before["counters"], after["counters"]), (counts, counts_after)):
        got = {k: source[1].get(k, 0) - source[0].get(k, 0)
               for k in ("cascade.stages", "cascade.planes")}
        assert got == {"cascade.stages": 3, "cascade.planes": planes}


def test_reference_constants_match_the_configuration():
    spec = harness.load_spec()
    cell = harness.Cell(spec, "casmvsnet.serve")
    model, stages = cell.config["model"], cell.config["stages"]
    assert tuple(stages["planes"]) == ref.PLANES == casmvsnet.PLANES
    assert tuple(stages["interval_ratios"]) == ref.RATIOS == casmvsnet.INTERVAL_RATIOS
    cfg = cell.model_config()
    assert cfg.cascade
    assert cell.config["reference"] == ref.__name__
    specs = {n: tuple(s) for n, s, _ in ref.param_specs(model)}
    assert specs == {n: tuple(t.shape) for n, t in CasMVSNet(cfg).state_dict().items()}


@pytest.mark.parametrize("name", ["mvsnet.serve", "rmvsnet.serve"])
def test_existing_configurations_config_json_as_jax_reads_it(name, tmp_path):
    cfg = harness.Cell(harness.load_spec(), name).model_config()
    path = str(tmp_path / "config.json")
    save_config(path, model=cfg)
    written = json.loads(Path(path).read_text())["model"]
    assert "cascade" not in written
    jax_model = jax_config.load_config(path)["model"]
    assert {k: getattr(jax_model, k) for k in written} == written
    assert load_config(path)["model"] == cfg


ARGS = ["--view_num", "3", "--max_d", "192", "--width", "64", "--height", "64",
        "--base_image_size", "32", "--compute_dtype", "float32", "--device", "cpu",
        "--cascade"]


def test_infer_driver_writes_the_cascade_at_full_resolution(tmp_path):
    session = make_session(str(tmp_path / "s"), width=64, height=64, n_images=3)
    assert infer.main(["--input_dir", session, "--max_clusters_per_session", "1"] + ARGS) == 0
    out = Path(session) / "depths_mvsnet"
    depth, prob = load_pfm(str(out / "0_init.pfm")), load_pfm(str(out / "0_prob.pfm"))
    assert depth.shape == prob.shape == (64, 64)
    assert np.isfinite(depth).all() and ((prob >= 0) & (prob <= 1 + 1e-6)).all()
    # the full images' cam: focal length as given, not scaled to a quarter
    cam = (out / "0.txt").read_text().split()
    assert float(cam[cam.index("intrinsic") + 1]) == pytest.approx(64 * 1.2)


def test_test_driver_serves_the_cascade(tmp_path):
    root = make_dataset(str(tmp_path / "d"), n_sessions=1, split="test", n_images=3,
                        width=64, height=64)
    results = str(tmp_path / "r.csv")
    assert port_test.main(["--input_dir", root, "--results_path", results, "--write_output",
                           "--max_clusters_per_session", "1"] + ARGS) == 0
    assert len(Path(results).read_text().splitlines()) == 2
    out = Path(root) / "test" / "session_0" / "depths_mvsnet"
    assert load_pfm(str(out / "0_prob.pfm")).shape == (64, 64)
