"""The port's training driver, `python -m mvsnet_tpu_torch.train`, on the
CPU (`--device cpu`), mirroring the JAX CLI tests of `tests/test_train.py`:
a smoke run, resuming from a checkpoint, `config.json` read across the two
packages, the NaN abort, validation rounds, and a two-rank gloo run
(`parallel.launch.spawn`) against the single-rank run; plus `entry()` and
the port's bench script.

The two-rank run takes each rank's half of a batch of 2 in the sharded
step (gradients summed, batch norms over the global batch) and is held to
the single-rank run on the same batches: SGD with momentum, so that an
update is the gradient times the rate and sums in another order move it
by float32 rounding only (the sharded step's gradients agree with the
single step's to 1e-4 of each leaf's largest entry,
`tests/test_torch_parallel.py`); each parameter's change over two steps
within 1e-3 of its leaf's largest change, the running statistics within
1e-5, the logged loss within 1e-5 relative.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from synthetic_session import make_dataset  # noqa: E402
from test_golden import tiny_inputs  # noqa: E402

import jax  # noqa: E402

import bench as jax_bench  # noqa: E402
from mvsnet_tpu import config as jax_config  # noqa: E402
from mvsnet_tpu import models as jax_models  # noqa: E402
from mvsnet_tpu import train as jax_train  # noqa: E402
from mvsnet_tpu_torch import bench, checkpoint, config, train  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig  # noqa: E402
from mvsnet_tpu_torch.entry import entry  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.parallel import rank_checks  # noqa: E402
from mvsnet_tpu_torch.parallel.launch import spawn  # noqa: E402

TINY = ["--view_num", "3", "--max_d", "8", "--width", "64", "--height", "64",
        "--base_image_size", "32", "--network_mode", "ultralite",
        "--compute_dtype", "float32", "--epoch", "1", "--max_steps_per_epoch", "2",
        "--optimizer", "adam", "--loss_type", "original", "--grad_loss", "false",
        "--num_devices", "1", "--snapshot", "1000"]


def _args(root, model_dir, *extra):
    return ["--train_data_root", root, "--model_dir", model_dir, *TINY,
            "--device", "cpu", *extra]


def _metrics(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_dataset(root, n_sessions=1, split="train", n_images=3)
    return root


def test_cli_driver_smoke(data, tmp_path):
    model_dir = str(tmp_path / "models")
    assert train.main(_args(data, model_dir)) == 0
    recs = _metrics(model_dir)
    assert recs and all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert checkpoint.latest_step(model_dir, "3DCNN", "ultralite") == 2
    assert os.path.exists(os.path.join(model_dir, "config.json"))


def test_cli_resume_from_checkpoint(data, tmp_path):
    """--ckpt_step resumes the trainer: the step counter continues past the
    restored step and the optimizer continues from the saved state."""
    model_dir = str(tmp_path / "models")
    assert train.main(_args(data, model_dir)) == 0
    step0 = checkpoint.latest_step(model_dir, "3DCNN", "ultralite")
    assert step0 == 2
    assert train.main(_args(data, model_dir, "--ckpt_step", str(step0))) == 0
    assert checkpoint.latest_step(model_dir, "3DCNN", "ultralite") == step0 + 2
    assert checkpoint.restore_tree(model_dir, "3DCNN", "ultralite")["step"] == 4


def test_config_json_across_packages(tmp_path):
    """A config.json written by either package loads in the other: JAX's
    TPU knobs are dropped by the port and take their defaults in JAX.
    `TrainConfig.remat` is kept both ways (read nowhere, as in JAX)."""
    argv = ["--train_data_root", "/data", "--model_dir", "/m", *TINY]
    port_cfgs = train.configs_from_args(train.build_parser().parse_args(argv))
    jax_cfgs = jax_train.configs_from_args(jax_train.build_parser().parse_args(argv))
    port_json, jax_json = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    config.save_config(port_json, **dict(zip(("model", "train", "data"), port_cfgs)))
    jax_config.save_config(jax_json, **dict(zip(("model", "train", "data"), jax_cfgs)))
    from_port = jax_config.load_config(port_json)
    assert (from_port["model"], from_port["train"], from_port["data"]) == tuple(jax_cfgs)
    from_jax = config.load_config(jax_json)
    assert (from_jax["model"], from_jax["train"], from_jax["data"]) == tuple(port_cfgs)
    assert config.JAX_ONLY_FIELDS["train"] == set() and from_jax["train"].remat is True
    assert from_port["train"].remat is True
    with open(jax_json) as f:
        raw = json.load(f)
    raw["train"]["remat"] = False
    with open(jax_json, "w") as f:
        json.dump(raw, f)
    assert config.load_config(jax_json)["train"] == dataclasses.replace(port_cfgs[1],
                                                                        remat=False)
    assert jax_config.load_config(jax_json)["train"].remat is False
    raw["train"]["no_such_field"] = 1
    with open(jax_json, "w") as f:
        json.dump(raw, f)
    with pytest.raises(TypeError):
        config.load_config(jax_json)


def test_cli_nan_loss_aborts(tmp_path):
    """A NaN loss ends the run with rc 1 and no final checkpoint."""
    root = str(tmp_path / "data")
    make_dataset(root, n_sessions=1, split="train", n_images=3)
    cams_dir = os.path.join(root, "train", "session_0", "cameras")
    for name in os.listdir(cams_dir):
        with open(os.path.join(cams_dir, name)) as f:
            cam = json.load(f)
        cam["intrinsics"]["fx"] = float("nan")
        with open(os.path.join(cams_dir, name), "w") as f:
            json.dump(cam, f)
    model_dir = str(tmp_path / "models")
    assert train.main(_args(root, model_dir)) == 1
    assert checkpoint.latest_step(model_dir, "3DCNN", "ultralite") is None


def test_cli_validation_rounds(tmp_path):
    root = str(tmp_path / "data")
    make_dataset(root, n_sessions=1, split="train", n_images=3)
    make_dataset(root, n_sessions=1, split="val", n_images=3)
    model_dir = str(tmp_path / "models")
    assert train.main(_args(root, model_dir, "--max_steps_per_epoch", "3",
                            "--train_steps_per_val", "1", "--val_batch_size", "2")) == 0
    vals = [r for r in _metrics(model_dir) if "val_loss" in r]
    assert [r["step"] for r in vals] == [2, 3]
    assert all({"val_less_one", "val_less_three", "val_debug"} <= set(r) for r in vals)
    assert all(np.isfinite(r["val_loss"]) for r in vals)


def test_unported_graphs_raise(data, tmp_path):
    """`--refinement` trains, on either regularizer, as JAX's driver does
    (its defaults: the U-Net, upsampled, with confidence): two steps with
    finite losses; `config.json` holds the configs JAX's driver builds
    from the same command line; the checkpoint's model holds the tensors
    of JAX's variables for that config under the port's names, the 3D-CNN
    graph's refinement net included and the GRU graph's without one (JAX
    ignores refinement there)."""
    for flag in (["--refinement"], ["--regularization", "GRU", "--refinement"]):
        model_dir = str(tmp_path / "-".join(flag))
        argv = _args(data, model_dir, *flag)
        assert train.main(argv) == 0
        recs = [r for r in _metrics(model_dir) if "loss" in r]
        assert recs and all(np.isfinite(r["loss"]) for r in recs)
        jax_argv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
        jax_cfgs = jax_train.configs_from_args(jax_train.build_parser().parse_args(jax_argv))
        saved = config.load_config(os.path.join(model_dir, "config.json"))
        port_model = dataclasses.asdict(saved["model"])
        # the port's own field stays at its default
        assert port_model.pop("cascade") is False
        assert port_model == {
            k: v for k, v in dataclasses.asdict(jax_cfgs[0]).items()
            if k not in config.JAX_ONLY_FIELDS["model"]}
        assert saved["model"].refinement and saved["model"].refinement_network == "unet"
        reg = saved["model"].regularization
        tree = checkpoint.restore_tree(model_dir, reg, "ultralite")
        jax_model = jax_models.MVSNet(jax_cfgs[0])
        images, cams, ds, di = tiny_inputs()
        shapes = jax.eval_shape(lambda k: jax_model.init(k, images, cams, ds, di),
                                jax.random.PRNGKey(0))
        names = {".".join(str(getattr(p, "key", p)) for p in path
                          if str(getattr(p, "key", p)) not in ("Conv_0", "ConvTranspose_0",
                                                                "BatchNorm_0"))[len("params."):]
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     {"params": shapes["params"]})[0]}
        params = {k for k in tree["model"] if not k.endswith((".mean", ".var"))}
        assert params == names
        assert any(k.startswith("refine_net.") for k in names) == (reg == "3DCNN")


def test_gru_training_run(data, tmp_path):
    """`--regularization GRU` trains R-MVSNet (classification loss) for two
    steps, with the image log's winner-take-all renders, and snapshots under
    GRU/<mode>."""
    model_dir = str(tmp_path / "models")
    assert train.main(_args(data, model_dir, "--regularization", "GRU",
                            "--image_log_interval", "1")) == 0
    recs = [r for r in _metrics(model_dir) if "loss" in r]
    assert recs and all(np.isfinite(r["loss"]) and np.isfinite(r["debug"]) for r in recs)
    assert checkpoint.latest_step(model_dir, "GRU", "ultralite") == 2
    tree = checkpoint.restore_tree(model_dir, "GRU", "ultralite")
    assert any(k.startswith("gru_sweep.gru.") for k in tree["model"])
    assert os.path.exists(os.path.join(model_dir, "train_vis", "step_1", "depth.png"))


def test_two_rank_gloo_run_matches_one_rank(data, tmp_path):
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    # 3 samples a pass: two passes stream 3 batches of 2, and 1 step an
    # epoch of 2 takes two of them
    # the two ranks read at the default worker count; the single rank reads
    # with one worker, in the generator's order
    extra = ["--batch_size", "2", "--epoch", "2", "--max_steps_per_epoch", "1",
             "--optimizer", "momentum", "--base_lr", "1e-2"]
    argv = _args(data, two, *extra)
    argv[argv.index("--num_devices") + 1] = "2"
    assert spawn(train.main, 2, "gloo", argv) == [0, 0]
    assert train.main(_args(data, one, *extra, "--loader_workers", "1")) == 0
    got = checkpoint.restore_tree(two, "3DCNN", "ultralite")
    want = checkpoint.restore_tree(one, "3DCNN", "ultralite")
    assert got["step"] == want["step"] == 2
    init = MVSNet(ModelConfig(view_num=3, max_d=8, width=64, height=64,
                              network_mode="ultralite", compute_dtype="float32"))
    params = {k: p.detach() for k, p in init.named_parameters()}
    for name, w in want["model"].items():
        g = got["model"][name]
        if name in params:
            scale = max(float((w - params[name]).abs().max()), 1e-12)
            assert float((g - w).abs().max()) <= 1e-3 * scale, name
        else:
            assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max())), name
    (loss_two,), (loss_one,) = ([r["loss"] for r in _metrics(d) if "loss" in r]
                                for d in (two, one))
    assert loss_two == pytest.approx(loss_one, rel=1e-5)


def test_ranks_read_one_global_batch_at_the_default_worker_count(tmp_path):
    """Inside a process group the driver's loader gives every rank the same
    global batches, in the generator's order, at the default worker count
    (whose pooled decode yields in completion order on a single rank), so
    each rank's slice of a step comes from one batch."""
    root = make_dataset(str(tmp_path), n_sessions=2, split="train", n_images=4)
    args = train.build_parser().parse_args(["--train_data_root", root, "--model_dir", "m",
                                            *TINY])
    assert args.loader_workers > 1
    _, tcfg, dcfg = train.configs_from_args(args)
    tcfg = dataclasses.replace(tcfg, batch_size=2)
    inp = {"data": dataclasses.asdict(dcfg), "tcfg": dataclasses.asdict(tcfg),
           "workers": args.loader_workers}
    (rank0,), (rank1,) = spawn(rank_checks.run, 2, "gloo", [("driver_batches", inp)])
    gen = train.make_loader(dcfg, tcfg, "train")()
    serial = [[rank_checks.sample_digest(s) for s in pair]
              for pair in zip(*[iter(gen.iterate_once())] * 2)]
    assert len(serial) == 4
    assert rank0 == rank1 == serial


def test_entry_on_cpu():
    forward, args = entry(device="cpu")
    model, images, cams, ds, di = args
    assert images.shape == (1, 3, 64, 64, 3) and model.cfg.network_mode == "lite"
    assert model.cfg.compute_dtype == "bfloat16" and model.cfg.max_d == 8
    depth, prob = forward(*args)
    assert depth.shape == prob.shape == (1, 16, 16, 1)
    assert torch.isfinite(depth).all() and torch.isfinite(prob).all()
    assert float(ds[0]) <= float(depth.min()) and float(depth.max()) <= float(ds[0] + 7 * di[0])


def test_bench_script_arguments_and_rig():
    assert bench.build_parser().parse_args([]).metric == "3dcnn"
    for m in ("3dcnn", "train", "gru", "train_gru", "all"):
        assert bench.build_parser().parse_args(["--metric", m]).metric == m
    with pytest.raises(SystemExit):
        bench.build_parser().parse_args(["--metric", "refine"])
    for args in ((3, 1152, 864, 425.0, 2.5 * 1.06, 192), (3, 640, 480, 425.0, 2.5, 192),
                 (2, 64, 48, 1.0, 0.5, 8)):
        np.testing.assert_array_equal(bench.make_rig(*args), jax_bench.make_rig(*args))
    if not torch.cuda.is_available():
        assert bench.main(["--metric", "all"]) == 1        # times the card or fails


def test_bench_metric_names_are_bench_py_names():
    """Each point prints under the name the repository's `bench.py` gives it."""
    with open(os.path.join(os.path.dirname(__file__), "..", "bench.py")) as f:
        source = f.read()
    assert set(bench.METRICS) == set(bench.POINTS)
    for name in bench.METRICS.values():
        assert f'"{name}"' in source, name


def test_gru_bench_points_run_on_cpu_at_a_tiny_size():
    """The gru and train_gru points' calls at 64x64, D=8 on the CPU's plain
    path (not timed: the timing needs a card)."""
    dev = torch.device("cpu")
    depth, prob = bench.gru_case(dev, 64, 64, 8, "ultralite", "float32")()
    assert depth.shape == prob.shape == (1, 16, 16, 1)
    assert torch.isfinite(depth).all() and torch.isfinite(prob).all()
    metrics = bench.train_case(dev, 64, 64, 8, "ultralite", "float32", regularization="GRU")()
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["debug"].item())


def test_bench_points_run_on_cpu_at_a_tiny_size():
    """The bench points' calls at 64x64, D=8 on the CPU's plain path (not
    timed: the timing needs a card)."""
    dev = torch.device("cpu")
    depth, prob = bench.inference_case(dev, 64, 64, 8, "ultralite", "float32")()
    assert depth.shape == prob.shape == (1, 16, 16, 1)
    assert torch.isfinite(depth).all() and torch.isfinite(prob).all()
    metrics = bench.train_case(dev, 64, 64, 8, "ultralite", "float32")()
    assert np.isfinite(metrics["loss"].item())
