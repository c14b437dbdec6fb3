"""The port's serving drivers, `python -m mvsnet_tpu_torch.infer` and
`python -m mvsnet_tpu_torch.test` (`--device cpu`), against the JAX
package's `mvsnet_tpu.infer` and `mvsnet_tpu.test` on the sessions of
tests/synthetic_session.py, with refinement and the same weights, file by
file.

The weights are seeded JAX variables (tests/test_torch_refine.py). The
port's drivers restore them from a checkpoint of the port through
`--model_dir --ckpt_step`; JAX's drivers get a `Predictor` holding them
(JAX's restore reads orbax checkpoints). 64x64 images, D=8, V=3,
`ultralite`, float32.

Tolerances: the PFMs the golden fixture's (depth and residual 2e-3, prob
5e-3, absolute and relative). A PNG is its PFM's values scaled and cut to
integers: each of the port's decodes to exactly what JAX's writer makes of
the port's PFM, and is held to JAX's PNG within the levels that the two
PFMs' measured difference spans, plus one for the cut. The reference
JPEG, the cam files and the results CSV's header and format are equal;
its numbers within 1e-3 relative (the loss of a depth map within the PFM
bounds).
"""

import os
import sys

import numpy as np
import pytest
import torch

import imageio.v2 as imageio
import jax

sys.path.insert(0, os.path.dirname(__file__))
from synthetic_session import make_dataset, make_session  # noqa: E402
from test_golden import tiny_inputs  # noqa: E402
from test_torch_refine import seeded_variables  # noqa: E402

from mvsnet_tpu import infer as jax_infer  # noqa: E402
from mvsnet_tpu import predict as jax_predict  # noqa: E402
from mvsnet_tpu import test as jax_test  # noqa: E402
from mvsnet_tpu.io import images as jax_images  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu_torch import checkpoint, infer, train_lib  # noqa: E402
from mvsnet_tpu_torch import test as port_test  # noqa: E402
from mvsnet_tpu_torch.config import TrainConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.io.pfm import load_pfm  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.parallel import rank_checks  # noqa: E402
from mvsnet_tpu_torch.parallel.launch import spawn  # noqa: E402

BASE = ["--view_num", "3", "--max_d", "8", "--width", "64", "--height", "64",
        "--base_image_size", "32", "--network_mode", "ultralite", "--compute_dtype", "float32"]
INFER = BASE + ["--refinement", "--refinement_network", "unet",
                "--upsample_before_refinement", "--refine_with_confidence", "--visualize"]
TEST = BASE + ["--refinement", "--write_output", "--visualize"]
STEP = 7
PFM_TOL = {"init": 2e-3, "prob": 5e-3, "residual": 2e-3}


def _weights(driver, argv, model_dir):
    """Seeded JAX variables for the driver's config, also saved as the
    port's checkpoint STEP under `model_dir`; returns (JAX config, variables)."""
    args = driver.build_parser().parse_args(argv)
    jcfg = jax_infer.model_config_from_args(args)
    model = JaxMVSNet(jcfg)
    images, cams, ds, di = tiny_inputs()
    v = seeded_variables(jax.eval_shape(lambda k: model.init(k, images, cams, ds, di),
                                        jax.random.PRNGKey(0)), 21)
    cfg = infer.model_config_from_args(args)
    port = MVSNet(cfg)
    port.load_state_dict(state_dict_from_jax(v))
    state = train_lib.create_train_state(port, cfg, TrainConfig(), device="cpu")
    checkpoint.save_checkpoint(model_dir, cfg.regularization, cfg.network_mode, STEP, state)
    return jcfg, v


def _jax_predictor(monkeypatch, variables):
    """JAX's drivers construct `Predictor(mcfg, model_dir, ckpt_step, ...)`:
    give them one that holds `variables`."""
    real = jax_predict.Predictor

    def make(mcfg, *args, **kwargs):
        p = real(mcfg)
        p.variables = variables
        return p
    monkeypatch.setattr(jax_predict, "Predictor", make)


def _compare_dirs(port_dir, jax_dir, tmp):
    """The two drivers' output dirs hold the same files: PFMs within
    PFM_TOL; each port PNG decodes to what JAX's writer makes of the port's
    own PFM, and to JAX's PNG within the levels its PFMs' difference spans
    plus one; JPEGs and cam files equal byte for byte."""
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    pfm, pfm_err = {}, {}
    for name in names:
        if name.endswith(".pfm"):
            a, b = load_pfm(os.path.join(port_dir, name)), load_pfm(os.path.join(jax_dir, name))
            kind = name.split("_", 1)[1][:-4]
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=PFM_TOL[kind], atol=PFM_TOL[kind],
                                       err_msg=name)
            pfm[name], pfm_err[name] = a, float(np.abs(a - b).max())
    writers = {"depth.png": ("init", jax_images.write_depth_png),
               "prob.png": ("prob", jax_images.write_confidence_png),
               "depth_inverse.png": ("init", jax_images.write_inverse_depth_png)}
    for name in names:
        path_p, path_j = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".png"):
            a, b = imageio.imread(path_p), imageio.imread(path_j)
            assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape, name
            index, suffix = name.split("_", 1)
            kind, write = writers[suffix]
            write(str(tmp / name), pfm[f"{index}_{kind}.pfm"])
            np.testing.assert_array_equal(a, imageio.imread(str(tmp / name)), err_msg=name)
            if suffix != "depth_inverse.png":    # the rendering rescales by the map's range
                scale = 65535.0 if kind == "prob" else 1.0
                levels = int(np.ceil(pfm_err[f"{index}_{kind}.pfm"] * scale)) + 1
                diff = np.abs(a.astype(np.int64) - b).max()
                assert diff <= levels, (name, diff, levels)
        elif name.endswith((".txt", ".jpg")):
            with open(path_p, "rb") as fp, open(path_j, "rb") as fj:
                assert fp.read() == fj.read(), name
    return names


def test_infer_driver_matches_jax(tmp_path, monkeypatch):
    """`infer.main` on one session, refined at the images' resolution with
    confidence (`--visualize`: the inverse-depth PNG and the residual PFM),
    the weights restored by `--model_dir --ckpt_step`."""
    model_dir = str(tmp_path / "models")
    _, v = _weights(infer, ["--input_dir", "x"] + INFER, model_dir)
    _jax_predictor(monkeypatch, v)
    sessions = {k: make_session(str(tmp_path / k), n_images=4, with_depths=False)
                for k in ("port", "jax")}
    ckpt = ["--model_dir", model_dir, "--ckpt_step", str(STEP)]
    assert infer.main(["--input_dir", sessions["port"], "--device", "cpu"] + INFER + ckpt) == 0
    assert jax_infer.main(["--input_dir", sessions["jax"]] + INFER + ckpt) == 0
    names = _compare_dirs(*(os.path.join(sessions[k], "depths_mvsnet") for k in ("port", "jax")),
                          tmp_path)
    assert "0_residual.pfm" in names and "3_depth_inverse.png" in names
    assert load_pfm(os.path.join(sessions["port"], "depths_mvsnet", "0_init.pfm")).shape == (64, 64)


def test_test_driver_matches_jax(tmp_path, monkeypatch):
    """`test.main` on a test split, refined at the cost volume's
    resolution (the driver's default U-Net), the depth resized to the
    ground truth for the loss; the per-cluster outputs and the results
    CSV's row."""
    model_dir = str(tmp_path / "models")
    _, v = _weights(port_test, ["--input_dir", "x"] + TEST, model_dir)
    _jax_predictor(monkeypatch, v)
    ckpt = ["--model_dir", model_dir, "--ckpt_step", str(STEP)]
    rows = {}
    for k, main, extra in (("port", port_test.main, ["--device", "cpu"]),
                           ("jax", jax_test.main, [])):
        root = str(tmp_path / k)
        make_dataset(root, n_sessions=1, split="test", n_images=4)
        results = str(tmp_path / f"{k}.csv")
        assert main(["--input_dir", root, "--results_path", results] + TEST + ckpt
                    + extra) == 0
        with open(results) as f:
            rows[k] = f.readlines()
    _compare_dirs(*(os.path.join(str(tmp_path / k), "test", "session_0", "depths_mvsnet")
                    for k in ("port", "jax")), tmp_path)
    assert rows["port"][0] == rows["jax"][0] == jax_predict.RESULTS_HEADER
    assert len(rows["port"]) == len(rows["jax"]) == 2
    port_row, jax_row = (rows[k][1].split(", ") for k in ("port", "jax"))
    assert port_row[:2] == jax_row[:2] == [model_dir, str(STEP)]
    assert port_row[-1].endswith(" \n") and jax_row[-1].endswith(" \n")
    np.testing.assert_allclose([float(x) for x in port_row[2:]],
                               [float(x) for x in jax_row[2:]], rtol=1e-3, atol=1e-6)


SERVED = {"3DCNN": [],
          "3DCNN-refined": ["--refinement", "--upsample_before_refinement"],
          "GRU": ["--regularization", "GRU", "--network_mode", "lite"],
          "GRU-refinement-flags": ["--regularization", "GRU", "--network_mode", "lite",
                                   "--refinement", "--upsample_before_refinement"],
          "cascade": ["--cascade", "--network_mode", "normal"]}


@pytest.mark.parametrize("kind", list(SERVED))
def test_predict_serves_the_models_serving_call(kind):
    """Each kind of model, configured from the drivers' flags: the
    Predictor's maps are its model's `serve` on the same inputs, bit for
    bit, and `maps_at_image_resolution` is the rule the drivers applied to
    their flags, `(refinement and upsample_before_refinement) or cascade`
    (for the GRU too, which ignores refinement, as JAX's drivers do)."""
    args = infer.build_parser().parse_args(["--input_dir", "x", "--device", "cpu"] + BASE
                                           + SERVED[kind])
    predictor = infer.make_predictor(infer.model_config_from_args(args), args)
    images, cams, ds, di = (np.array(a, np.float32) for a in tiny_inputs())
    inputs = (images, cams, ds, di, ds + 7 * di)
    got = predictor.predict(*inputs)
    with torch.inference_mode():
        want = predictor.model.serve(*(torch.as_tensor(a) for a in inputs))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    rule = bool(args.refinement and args.upsample_before_refinement) or args.cascade
    assert predictor.model.maps_at_image_resolution == rule
    assert (got[0].shape[1:3] == images.shape[2:4]) == (kind in ("3DCNN-refined", "cascade"))


@pytest.mark.parametrize("main", [port_test.main, jax_test.main])
def test_test_driver_without_clusters_returns_1(tmp_path, main):
    """No test sessions: both drivers log it and return 1."""
    os.makedirs(tmp_path / "test")
    extra = ["--device", "cpu"] if main is port_test.main else []
    assert main(["--input_dir", str(tmp_path), "--results_path",
                 str(tmp_path / "r.csv")] + BASE + extra) == 1


def test_drivers_need_a_card_by_default(tmp_path):
    """`--device` defaults to cuda:0, which raises where CUDA is absent;
    `--device cpu` runs the plain path (the tests above)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    session = make_session(str(tmp_path / "s"), n_images=3, with_depths=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--input_dir", session] + BASE)
    root = make_dataset(str(tmp_path / "d"), n_sessions=1, split="test", n_images=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_test.main(["--input_dir", root, "--results_path", str(tmp_path / "r.csv")] + BASE)


def test_infer_driver_on_two_ranks_matches_one_process(tmp_path):
    """`--num_devices 2` inside a process group of two gloo ranks (as
    torchrun starts them; here `parallel.launch.spawn`): both ranks serve
    each cluster (the latency regime), rank 0 alone writes, and its files
    equal the single process's: PFMs within 1e-5 (float32 sums over the
    ranks' blocks, tests/test_torch_parallel.py's bound), the reference
    images and cam files byte for byte (the PNGs render the PFMs)."""
    argv = BASE + ["--refinement", "--device", "cpu"]
    one, two = (make_session(str(tmp_path / k), n_images=3, with_depths=False)
                for k in ("one", "two"))
    assert infer.main(["--input_dir", one] + argv) == 0
    rcs = spawn(rank_checks.run, 2, "gloo",
                [("infer_driver", {"argv": ["--input_dir", two, "--num_devices", "2"] + argv})])
    assert rcs == [[0], [0]]
    out_one, out_two = (os.path.join(d, "depths_mvsnet") for d in (one, two))
    names = sorted(os.listdir(out_one))
    assert sorted(os.listdir(out_two)) == names and "2_init.pfm" in names
    for name in names:
        a, b = (os.path.join(d, name) for d in (out_one, out_two))
        if name.endswith(".pfm"):
            np.testing.assert_allclose(load_pfm(b), load_pfm(a), rtol=1e-5, atol=1e-5)
        elif not name.endswith(".png"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
