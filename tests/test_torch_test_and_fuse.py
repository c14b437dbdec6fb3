"""The port's test-and-fuse chain (`mvsnet_tpu_torch/scripts/`) on the CPU
against `scripts/test_and_fuse.py`, at 64x64, D=8, "ultralite".

The port runs inference and fusion in-process (`--device cpu`). The
pre-port script launches `python -m mvsnet_tpu.infer` (80 s of JAX
compilation here) and `-m mvsnet_tpu.fusion`; it is run with --no_test on a
copy of the session holding the port's maps, so that both fuse the same
depth maps. Both collect one PLY per session into the run folder, with the
same points, and write the same results-CSV fields."""

import os
import shutil

import numpy as np
import pytest

from mvsnet_tpu_torch.io.ply import read_ply
from mvsnet_tpu_torch.scripts import seven_scenes_test, test_and_fuse, utils
from tests.synthetic_session import make_session

INFER = ["--view_num", "3", "--max_d", "8", "--width", "64", "--height", "64",
         "--network_mode", "ultralite", "--compute_dtype", "float32"]
FUSE = ["--prob_threshold", "0", "--disp_threshold", "1.0", "--num_consistent", "1"]


def _run_folder(root):
    runs = os.listdir(root)
    assert len(runs) == 1
    return os.path.join(root, runs[0])


def test_test_and_fuse_equals_the_pre_port_script(tmp_path, monkeypatch):
    from scripts.test_and_fuse import main as pre_main

    root = tmp_path / "sessions"
    for k in range(2):
        make_session(str(root / f"s{k}"), width=64, height=64, n_images=3, seed=k,
                     with_depths=False)
    (root / "notes.txt").write_text("not a session")
    out = {k: (str(tmp_path / f"plys_{k}"), str(tmp_path / f"{k}.csv")) for k in ("pre", "port")}
    assert test_and_fuse.main(["--test_folder_root", str(root), "--ply_folder", out["port"][0],
                               "--results_path", out["port"][1], "--device", "cpu", *FUSE,
                               "--infer_args", *INFER]) == 0
    pre_root = tmp_path / "pre_sessions"
    shutil.copytree(root, pre_root)
    for k in range(2):
        shutil.rmtree(pre_root / f"s{k}" / "points_mvsnet")
    monkeypatch.setenv("MVSNET_TPU_PLATFORM", "cpu")
    assert pre_main(["--test_folder_root", str(pre_root), "--no_test", "--ply_folder",
                     out["pre"][0], "--results_path", out["pre"][1], *FUSE]) == 0

    plys = {k: sorted(os.listdir(_run_folder(v[0]))) for k, v in out.items()}
    assert plys["port"] == plys["pre"] == ["s0.ply", "s1.ply"]
    for name in plys["port"]:
        a, b = (read_ply(os.path.join(_run_folder(out[k][0]), name))[0] for k in ("pre", "port"))
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(np.sort(b, axis=0), np.sort(a, axis=0), atol=1e-3)
    rows = {k: [line.split(", ") for line in open(v[1])] for k, v in out.items()}
    assert len(rows["port"]) == 3 and rows["port"] == rows["pre"]
    with open(out["port"][1]) as f:
        assert f.readlines()[-1] == "None, None, [[], []], 0.0, 1.0, 1 \n"


def test_test_only_seven_scenes_and_device_forwarding(tmp_path, monkeypatch):
    """--test_only writes maps and no cloud; the 7-Scenes batch runs the
    sessions it finds; `utils.test` and `utils.fuse` pass `--device` to the
    drivers unless the caller's arguments hold one."""
    data = tmp_path / "7scenes"
    session = make_session(str(data / "heads_1_mvs_training"), width=64, height=64,
                           n_images=3, with_depths=False)
    assert seven_scenes_test.main(["--data_root", str(data), "--device", "cpu", "--test_only",
                                   "--ply_folder", str(tmp_path / "plys"), "--results_path",
                                   str(tmp_path / "r.csv"), "--infer_args", *INFER]) == 0
    assert "0_init.pfm" in os.listdir(os.path.join(session, "depths_mvsnet"))
    assert not os.path.exists(os.path.join(session, "points_mvsnet"))
    calls = []
    monkeypatch.setattr("mvsnet_tpu_torch.infer.main", lambda argv: calls.append(argv) or 0)
    monkeypatch.setattr("mvsnet_tpu_torch.fusion.main", lambda argv: calls.append(argv) or 0)
    assert utils.test("s", 5, "m", extra_args=["--max_d", "8"], device="cpu") == 0
    assert utils.test("s", extra_args=["--device", "cuda:1"], device="cpu") == 0
    assert utils.fuse("s", 0.5, 1.0, 2, device="cuda:0") == 0
    assert calls == [
        ["--input_dir", "s", "--ckpt_step", "5", "--model_dir", "m", "--max_d", "8",
         "--device", "cpu"],
        ["--input_dir", "s", "--device", "cuda:1"],
        ["--dense_folder", "s", "--prob_threshold", "0.5", "--disp_threshold", "1.0",
         "--num_consistent", "2", "--device", "cuda:0"]]


def test_sketchfab_upload_needs_a_token(monkeypatch, tmp_path):
    """Opt-in: without SKETCHFAB_API_TOKEN the upload raises before any
    request (its HTTP client is imported inside the function)."""
    from mvsnet_tpu_torch.scripts import sketchfab

    monkeypatch.delenv("SKETCHFAB_API_TOKEN", raising=False)
    monkeypatch.setitem(__import__("sys").modules, "requests", type("R", (), {})())
    with pytest.raises(RuntimeError, match="SKETCHFAB_API_TOKEN"):
        sketchfab.upload(str(tmp_path / "x.ply"))
