"""The port's tools against the JAX package's on the CPU: the PLY and dmb
files (`io/ply.py`, `io/dmb.py`), the DTU sample lists (`data/dtu.py`),
`visualize.py`, `utils/profiling.py`, `python -m mvsnet_tpu_torch`, and a
port-written Saver V2 bundle read by TensorFlow's own reader.

Everything here is exact: file bytes, arrays read back and path lists are
equal, not close.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package below needs it on the CPU)

from mvsnet_tpu import visualize as jax_visualize
from mvsnet_tpu.data import dtu as jax_dtu
from mvsnet_tpu.io import dmb as jax_dmb
from mvsnet_tpu.io import images as jax_images
from mvsnet_tpu.io import ply as jax_ply
from mvsnet_tpu.io.pfm import write_pfm as jax_write_pfm
from mvsnet_tpu_torch import __main__ as port_main
from mvsnet_tpu_torch import visualize
from mvsnet_tpu_torch.data import dtu
from mvsnet_tpu_torch.io import dmb, ply, tf_bundle
from mvsnet_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("with_colors", [True, False])
def test_ply_matches_jax(tmp_path, with_colors):
    rng = np.random.default_rng(0)
    points = rng.standard_normal((500, 3)).astype(np.float32) * 100
    colors = rng.integers(0, 255, (500, 3), dtype=np.uint8) if with_colors else None
    ply.write_ply(tmp_path / "port.ply", points, colors=colors)
    jax_ply.write_ply(tmp_path / "jax.ply", points, colors=colors)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for read in (ply.read_ply, jax_ply.read_ply):
        p, c = read(tmp_path / "port.ply")
        np.testing.assert_array_equal(p, points)
        assert (c is None) == (colors is None)
        if colors is not None:
            np.testing.assert_array_equal(c, colors)


@pytest.mark.parametrize("channels", [None, 3])
def test_dmb_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(1)
    shape = (12, 17) if channels is None else (12, 17, channels)
    image = rng.standard_normal(shape).astype(np.float32)
    dmb.write_dmb(tmp_path / "port.dmb", image)
    jax_dmb.write_dmb(tmp_path / "jax.dmb", image)
    assert (tmp_path / "port.dmb").read_bytes() == (tmp_path / "jax.dmb").read_bytes()
    np.testing.assert_array_equal(jax_dmb.read_dmb(tmp_path / "port.dmb"), image)
    np.testing.assert_array_equal(dmb.read_dmb(tmp_path / "jax.dmb"), image)


@pytest.fixture
def dtu_folder(tmp_path):
    """A DTU-layout folder: Cameras/pair.txt (5 reference views, one with
    too few neighbours for 4 views) and a pipeline export's pair.txt."""
    rng = np.random.default_rng(2)
    lines = ["5"]
    for ref in range(5):
        n = 1 if ref == 3 else 4
        views = rng.permutation([v for v in range(5) if v != ref])[:n]
        lines += [str(ref), f"{n} " + " ".join(f"{v} {rng.random() * 100:.2f}" for v in views)]
    (tmp_path / "Cameras").mkdir()
    (tmp_path / "Cameras" / "pair.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "pair.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path)


def test_dtu_lists_match_jax(dtu_folder):
    assert dtu.TRAINING_SET == jax_dtu.TRAINING_SET
    assert dtu.VALIDATION_SET == jax_dtu.VALIDATION_SET
    assert dtu.EVALUATION_SET == jax_dtu.EVALUATION_SET
    pair = os.path.join(dtu_folder, "pair.txt")
    assert dtu.parse_pair_txt(pair) == jax_dtu.parse_pair_txt(pair)
    for mode in ("training", "validation"):
        for view_num in (3, 4):
            got = dtu.gen_dtu_resized_path(dtu_folder, mode, view_num)
            assert got == jax_dtu.gen_dtu_resized_path(dtu_folder, mode, view_num)
            assert got
    for view_num in (2, 3):
        assert (dtu.gen_pipeline_mvs_list(dtu_folder, view_num)
                == jax_dtu.gen_pipeline_mvs_list(dtu_folder, view_num))


def test_load_depth_any_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    depth = rng.uniform(400, 900, (10, 14)).astype(np.float32)
    jax_write_pfm(str(tmp_path / "d.pfm"), depth)
    jax_dmb.write_dmb(str(tmp_path / "d.dmb"), depth)
    np.save(tmp_path / "d.npy", depth)
    jax_images.write_depth_png(str(tmp_path / "d.png"), depth)
    for ext in ("pfm", "dmb", "npy", "png"):
        path = str(tmp_path / f"d.{ext}")
        got = visualize.load_depth_any(path)
        np.testing.assert_array_equal(got, jax_visualize.load_depth_any(path))
        # a depth PNG holds whole millimetres, cut (tests/test_torch_drivers.py)
        want = depth.astype(np.uint16).astype(np.float32) if ext == "png" else depth
        np.testing.assert_array_equal(np.squeeze(got), want)
    with pytest.raises(ValueError, match="unsupported"):
        visualize.load_depth_any(str(tmp_path / "d.tif"))


def test_visualize_main_saves(tmp_path, capsys):
    depth = np.zeros((8, 9), np.float32)
    depth[2:6, 3:7] = np.arange(16).reshape(4, 4) + 500
    np.save(tmp_path / "d.npy", depth)
    assert visualize.main([str(tmp_path / "d.npy"), "--save", str(tmp_path / "d.png")]) == 0
    assert (tmp_path / "d.png").stat().st_size > 0
    assert "value range: 500.0 .. 515.0" in capsys.readouterr().out


def test_profiling_trace_and_counters(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    # `train.py --profile_dir` writes through the same exporter
    prof = profiling.start("cpu")
    torch.ones(8, 8) @ torch.ones(8, 8)
    path = profiling.stop(prof, str(tmp_path / "steps"), "trace_rank0.json")
    assert path == str(tmp_path / "steps" / "trace_rank0.json")
    assert any(e["name"] == "aten::mm" for e in json.loads(Path(path).read_text())["traceEvents"])
    assert profiling.device_memory_stats() is None           # no CUDA here


def test_package_lists_its_entry_points():
    out = subprocess.run([sys.executable, "-m", "mvsnet_tpu_torch"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for mod in port_main.COMMANDS:
        assert mod in out.stdout
        assert (ROOT / (mod.replace(".", "/") + ".py")).is_file(), mod


def test_tensorflow_reads_a_port_bundle(tmp_path):
    """The reference's own reader takes the port's Saver V2 files."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(4)
    tensors = {"2dconv0_0/conv/kernel": rng.standard_normal((3, 3, 3, 8)).astype(np.float32),
               "3dconv1_0/bn/moving_mean": rng.standard_normal(16).astype(np.float32),
               "global_step": np.asarray(150000, np.int64)}
    prefix = str(tmp_path / "tf_model_150000.ckpt")
    tf_bundle.write_bundle(prefix, tensors)
    reader = tf.train.load_checkpoint(prefix)
    assert set(reader.get_variable_to_shape_map()) == set(tensors)
    for name, value in tensors.items():
        np.testing.assert_array_equal(reader.get_tensor(name), value)
