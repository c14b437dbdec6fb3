"""The port's data tools (`mvsnet_tpu_torch/tools/`) against their pre-port
counterparts (`tools/`) on the same inputs: a tiny DTU layout written by
`data.synthetic.write_dtu_scan` through convert_dtu, dtu_fixer and
split_data; DeMoN scenes through convert_demon and its --fix; the point
cloud scorer; the hyperparameter search; the dataset download offline
(boto3 blocked, so nothing is fetched); the loader harness on a session
that `data.synthetic.write_session` writes. Session JSONs, cams and depth
arrays equal; the JPEGs equal byte for byte (both are imageio's default
write); the scorer's metrics within 1e-12 relative."""

import json
import os
import random
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import convert_demon as pre_demon  # noqa: E402
import convert_dtu as pre_dtu  # noqa: E402
import download_dataset as pre_download  # noqa: E402
import dtu_fixer as pre_fixer  # noqa: E402
import eval_pointcloud as pre_eval  # noqa: E402
import hp_search as pre_hp  # noqa: E402
import prototype_datagen as pre_datagen  # noqa: E402
import split_data as pre_split  # noqa: E402

from mvsnet_tpu_torch.data.synthetic import write_dtu_scan, write_session  # noqa: E402
from mvsnet_tpu_torch.io import images  # noqa: E402
from mvsnet_tpu_torch.io.ply import write_ply  # noqa: E402
from mvsnet_tpu_torch.tools import (convert_demon, convert_dtu,  # noqa: E402
                                    download_dataset, dtu_fixer, eval_pointcloud, hp_search,
                                    prototype_datagen, split_data)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def _assert_same_sessions(pre_root, port_root):
    """Every file of the two trees: JSON equal as data, PNG samples equal
    (cv2 reads the pre-port's, the port's decoder its own), the rest equal
    byte for byte."""
    names = _files(pre_root)
    assert names and _files(port_root) == names
    for name in names:
        a, b = Path(pre_root) / name, Path(port_root) / name
        if name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), name
        elif name.endswith(".png"):
            want = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
            got = images.read_png(str(b))
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        else:
            assert a.read_bytes() == b.read_bytes(), name
    return names


def test_dtu_chain_equals_the_pre_port_tools(tmp_path):
    """convert_dtu -> dtu_fixer -> split_data on a rendered DTU scan (4 views,
    2 lightings, 40x32 images, 10x8 depth PFMs), pre-port and port."""
    dtu = tmp_path / "dtu"
    write_dtu_scan(str(dtu), width=40, height=32, n_views=4, n_lightings=2, workers=2)
    out = {k: tmp_path / k for k in ("pre", "port")}
    pre_dtu.convert_dtu(str(dtu), str(out["pre"]), num_views=4, num_lightings=2)
    convert_dtu.convert_dtu(str(dtu), str(out["port"]), num_views=4, num_lightings=2)
    names = _assert_same_sessions(out["pre"], out["port"])
    assert "dtu_scan_0_lighting_1/images/3.jpg" in names
    depth = images.read_png(str(out["port"] / "dtu_scan_0_lighting_0/depths/0.png"))
    assert depth.shape == (8, 10) and depth.dtype == np.uint16
    # the images read back through the port's decoder as JAX's load_image reads them
    from mvsnet_tpu.io.images import load_image as jax_load_image
    jpg = str(out["port"] / "dtu_scan_0_lighting_1/images/2.jpg")
    np.testing.assert_array_equal(images.load_image(jpg), jax_load_image(jpg))

    pre_fixer.fix_depths(str(out["pre"]))
    dtu_fixer.fix_depths(str(out["port"]))
    _assert_same_sessions(out["pre"], out["port"])
    depth = images.read_png(str(out["port"] / "dtu_scan_0_lighting_0/depths/0.png"))
    assert depth.shape == (512, 640)
    # the fixer's cameras are the rendered ones again
    from mvsnet_tpu_torch.data import synthetic
    cam = json.loads((out["port"] / "dtu_scan_0_lighting_0/cameras/1.json").read_text())
    want = synthetic.render_session(40, 32, n_images=4, plane_depth_mm=synthetic.DTU_PLANE_MM,
                                    baseline_mm=synthetic.DTU_BASELINE_MM)["cameras"][1]
    for k in ("fx", "fy", "px", "py"):
        assert cam["intrinsics"][k] == pytest.approx(want["intrinsics"][k], rel=1e-12)

    pre_split.split_data(str(out["pre"]), 0.5, 0.5, 0.0, seed=3)
    assert split_data.main([str(out["port"]), "--train", "0.5", "--val", "0.5", "--test", "0",
                            "--seed", "3"]) == 0
    for split in ("train", "val", "test"):
        assert (sorted(os.listdir(out["pre"] / split))
                == sorted(os.listdir(out["port"] / split))), split


def _demon_scene(d, n, rng):
    d.mkdir(parents=True)
    np.savetxt(d / "cam.txt", [[500.0, 0, 64], [0, 505.0, 48], [0, 0, 1]])
    poses = np.concatenate([np.eye(3, 4).reshape(1, 12) + rng.normal(0, 0.1, (1, 12))
                            for _ in range(n)])
    np.savetxt(d / "poses.txt", poses)
    for i in range(n):
        depth = rng.uniform(0.5, 9.0, (12, 16))
        depth[0, :3] = [0.0, 70.0, 0.3]           # an invalid code and the clip
        np.save(d / f"{i:04d}.npy", depth)
        cv2.imwrite(str(d / f"{i:04d}.jpg"), rng.integers(0, 256, (12, 16, 3)).astype(np.uint8))


def test_demon_conversion_and_fix_equal_the_pre_port_tools(tmp_path):
    """convert_demon and its --fix: the same cameras, depth PNGs and
    covisibility; the fixer deletes the same uint8-depth and broken
    sessions and writes the same depth ranges (reading each PNG at its own
    bit depth)."""
    for side in ("pre", "port"):
        rng = np.random.default_rng(0)
        for k in range(2):
            _demon_scene(tmp_path / side / f"scene_{k}", 3, rng)
    pre_demon.convert_demon(str(tmp_path / "pre"))
    assert convert_demon.main([str(tmp_path / "port")]) == 0
    _assert_same_sessions(tmp_path / "pre", tmp_path / "port")

    for side in ("pre", "port"):
        bad = tmp_path / side / "bad8" / "depths"
        bad.mkdir(parents=True)
        images.write_png(str(bad / "0.png"), np.full((8, 8), 100, np.uint8))
        (tmp_path / side / "broken" / "depths").mkdir(parents=True)
        images.write_depth_png(str(tmp_path / side / "broken" / "depths" / "0.png"),
                               np.full((8, 8), 5000))
    pre_demon.fix_demon(str(tmp_path / "pre"))
    assert convert_demon.main(["--fix", str(tmp_path / "port")]) == 0
    assert sorted(os.listdir(tmp_path / "port")) == ["scene_0", "scene_1"]
    _assert_same_sessions(tmp_path / "pre", tmp_path / "port")


def test_eval_pointcloud_equals_the_pre_port_scorer(tmp_path, capsys):
    rng = np.random.default_rng(4)
    gt = np.concatenate([rng.uniform(0, 100, (3000, 2)), np.zeros((3000, 1))], axis=1)
    pred = np.concatenate([gt[:2000] + [0, 0, 0.7], gt[2000:2400] + [0, 0, 30.0]])
    pred = (pred + rng.normal(0, 0.2, pred.shape)).astype(np.float32)
    paths = {k: str(tmp_path / f"{k}.ply") for k in ("pred", "gt")}
    write_ply(paths["pred"], pred)
    write_ply(paths["gt"], gt.astype(np.float32))
    for kwargs in ({}, {"bbox_margin": 5.0, "threshold": 1.0, "percentile": 75.0}):
        a = pre_eval.evaluate_clouds(pred.astype(np.float64), gt, **kwargs)
        b = eval_pointcloud.evaluate_clouds(pred.astype(np.float64), gt, **kwargs)
        assert a.keys() == b.keys()
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=1e-12, abs=0), k
    lines = []
    for tool in (pre_eval, eval_pointcloud):
        assert tool.main(["--pred", paths["pred"], "--gt", paths["gt"], "--voxel", "0.5",
                          "--max_points", "2500", "--bbox_margin", "2"]) == 0
        lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert lines[0].keys() == lines[1].keys()
    for k in lines[0]:
        assert lines[1][k] == pytest.approx(lines[0][k], rel=1e-12, abs=0), k


def test_hp_search_equals_the_pre_port_search_and_trains_with_the_port(tmp_path,
                                                                      monkeypatch):
    space = json.loads((ROOT / "configs" / "hp_tuning.json").read_text())

    def objective(t, params):
        return -sum((np.log(v) if isinstance(v, float) else v / 100.0) ** 2
                    for v in params.values()) if t % 3 else None

    for strategy in ("bayes", "random"):
        a = pre_hp.run_search(space, 7, objective, random.Random(2), strategy, 3)
        b = hp_search.run_search(space, 7, objective, random.Random(2), strategy, 3)
        assert a == b
    commands = {}

    def fake_call(cmd, module):
        model_dir = cmd[cmd.index("--model_dir") + 1]
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, "metrics.jsonl"), "w") as f:
            score = len(commands.get(module, [])) * 0.1
            f.write(json.dumps({space["objective"]["metric"]: score}) + "\n")
        commands.setdefault(module, []).append(cmd)
        return 0

    monkeypatch.setattr(pre_hp.subprocess, "call", lambda cmd: fake_call(cmd, "pre"))
    argv = ["--train_data_root", str(tmp_path / "data"), "--trials", "2", "--max_steps", "3"]
    assert pre_hp.main(argv + ["--model_root", str(tmp_path / "pre")]) == 0
    monkeypatch.setattr(hp_search.subprocess, "call", lambda cmd: fake_call(cmd, "port"))
    assert hp_search.main(argv + ["--model_root", str(tmp_path / "port"), "--device",
                                  "cpu"]) == 0
    for pre, port in zip(commands["pre"], commands["port"]):
        assert port[1:3] == ["-m", "mvsnet_tpu_torch.train"] and pre[2] == "mvsnet_tpu.train"
        i = port.index("--device")
        assert port[i + 1] == "cpu"
        strip = port[:i] + port[i + 2:]
        assert strip[3:] == [x.replace(str(tmp_path / "pre"), str(tmp_path / "port"))
                             for x in pre[3:]]
    results = [json.loads((tmp_path / k / "hp_search_results.json").read_text())
               for k in ("pre", "port")]
    assert results[0] == results[1]


def test_download_dataset_runs_offline(tmp_path, capsys, monkeypatch):
    """With boto3 missing (blocked here, so nothing is fetched, whatever is
    installed): an unknown dataset returns 2 and a known one prints the
    `aws s3 sync` command and returns 1, as the pre-port tool does, line
    for line; the datasets are the same."""
    monkeypatch.setitem(sys.modules, "boto3", None)      # import boto3 raises ImportError
    assert download_dataset.DATASETS == pre_download.DATASETS
    out = str(tmp_path / "out")
    for dataset, rc in (("no-such-dataset", 2), ("mvs-training", 1), ("7scenes-test", 1)):
        assert pre_download.download(dataset, out) == rc
        want = capsys.readouterr().out
        assert download_dataset.download(dataset, out) == rc
        assert capsys.readouterr().out == want
    assert f"aws s3 sync s3://u6-mvs-datasets/7scenes/test/ {out}" in want
    assert not os.path.exists(out)
    with pytest.raises(SystemExit):
        download_dataset.main(["no-such-dataset", out])


def test_prototype_datagen_consumes_the_pre_port_batch_count(tmp_path, capsys):
    """`tools.prototype_datagen.main` (the port's data plane) and the
    pre-port harness on one rendered session (64x64, 5 images): both
    return 0 and report the same batch count, `--batches 3` of a batch of
    2 (the loader runs more than one epoch of the 5 clusters)."""
    write_session(str(tmp_path / "train" / "session_0"), 64, 64, 5, seed=0)
    argv = [str(tmp_path), "--batches", "3", "--batch_size", "2", "--width", "64",
            "--height", "64", "--max_d", "8"]
    counts = []
    for tool in (pre_datagen, prototype_datagen):
        (tmp_path / "train" / "clusters.pickle").unlink(missing_ok=True)
        assert tool.main(argv) == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        counts.append(last.split(" batches in ")[0])
        assert "batches/s" in last and "samples/s" in last
    assert counts == ["3", "3"]
