"""Depth fusion in the port (`fusion.py`, `native/`) against the JAX
package's (`mvsnet_tpu/fusion.py`, `mvsnet_tpu/native/`) on the CPU.

The scene is tests/test_fusion_quality.py's: analytic depth maps of a
sphere cap in front of a background plane, seen by 4 translated cameras at
96x96, prob 1. Both packages fuse the same session files, with the
quality test's thresholds and with the defaults, with the native
consolidation, and in two shards then merged.

Tolerances: the PLY point counts and colours are equal; the points agree
within 1e-4 of the scene's depth (BG_DEPTH): float32 projections through
3x3 products taken in another order move a fused point by ulps of its
coordinates (~1e-4 mm at 2400 mm). A voxel merge averages such points, so
its output agrees within the same bound, compared after sorting (the hash
order of the merge is not the sorted order). The gipuma export is
byte-identical. The native library equals JAX's and the numpy plain
versions exactly, after sorting.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package below needs it on the CPU)

sys.path.insert(0, os.path.dirname(__file__))
from synthetic_session import make_session  # noqa: E402
from test_fusion_quality import BG_DEPTH, CENTER, RADIUS, _write_sphere_predictions  # noqa: E402

from mvsnet_tpu import fusion as jax_fusion  # noqa: E402
from mvsnet_tpu import native as jax_native  # noqa: E402
from mvsnet_tpu.io.ply import read_ply as jax_read_ply  # noqa: E402
from mvsnet_tpu_torch import fusion, native  # noqa: E402
from mvsnet_tpu_torch.io.ply import read_ply  # noqa: E402

POINT_TOL = 1e-4 * BG_DEPTH
QUALITY = dict(prob_threshold=0.5, disp_threshold=1.0, num_consistent=2,
               depth_rel_threshold=0.01)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    root = tmp_path_factory.mktemp("fusion")
    s = make_session(str(root / "s"), n_images=4)
    _write_sphere_predictions(s, os.path.join(s, "depths_mvsnet"))
    return s


def _sorted(points, colors):
    order = np.lexsort(points.T[::-1])
    return points[order], colors[order]


def _fuse_both(session, tmp_path, **kw):
    a = jax_read_ply(jax_fusion.fuse_session(session, output_path=str(tmp_path / "jax.ply"),
                                             **kw))
    b = read_ply(fusion.fuse_session(session, output_path=str(tmp_path / "port.ply"),
                                     device="cpu", **kw))
    return a, b


@pytest.mark.parametrize("thresholds", ["quality", "defaults"])
def test_fuse_session_matches_jax(session, tmp_path, thresholds):
    kw = QUALITY if thresholds == "quality" else {}
    (pa, ca), (pb, cb) = _fuse_both(session, tmp_path, **kw)
    assert len(pa) == len(pb) > 3000
    np.testing.assert_allclose(pb, pa, atol=POINT_TOL, rtol=0)
    np.testing.assert_array_equal(cb, ca)


def test_fuse_session_native_consolidation_matches_jax(session, tmp_path):
    (pa, ca), (pb, cb) = _fuse_both(session, tmp_path, voxel_size=6.0, min_neighbors=4,
                                    **QUALITY)
    (full, _), _ = _fuse_both(session, tmp_path, **QUALITY)
    assert len(pa) == len(pb) and 100 < len(pa) < len(full)
    (pa, ca), (pb, cb) = _sorted(pa, ca), _sorted(pb, cb)
    np.testing.assert_allclose(pb, pa, atol=POINT_TOL, rtol=0)
    np.testing.assert_array_equal(cb, ca)


def test_shards_merge_to_the_whole_cloud(session, tmp_path):
    """Two shards of reference views, then `merge_shards`: the JAX
    package's merged cloud, and the unsharded cloud's points."""
    whole = read_ply(fusion.fuse_session(session, output_path=str(tmp_path / "w.ply"),
                                         device="cpu", **QUALITY))
    merged = {}
    for name, pkg, extra in (("jax", jax_fusion, {}), ("port", fusion, {"device": "cpu"})):
        for k in range(2):
            pkg.fuse_session(session, shard_index=k, shard_count=2, **QUALITY, **extra)
        merged[name] = read_ply(pkg.merge_shards(session, str(tmp_path / f"{name}.ply")))
    assert len(merged["port"][0]) == len(merged["jax"][0]) == len(whole[0])
    np.testing.assert_allclose(merged["port"][0], merged["jax"][0], atol=POINT_TOL, rtol=0)
    np.testing.assert_array_equal(merged["port"][1], merged["jax"][1])
    a, b = _sorted(*merged["port"]), _sorted(*whole)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_fused_sphere_quality(session, tmp_path):
    """tests/test_fusion_quality.py's accuracy and completeness gates on
    the port's cloud."""
    points, _ = read_ply(fusion.fuse_session(session, output_path=str(tmp_path / "q.ply"),
                                             device="cpu", **QUALITY))
    dist_sphere = np.abs(np.linalg.norm(points - CENTER, axis=1) - RADIUS)
    dist_bg = np.abs(points[:, 2] - BG_DEPTH)
    on_sphere = dist_sphere < dist_bg
    assert on_sphere.sum() > 300
    acc = dist_sphere[on_sphere]
    assert np.median(acc) < 0.5 and np.percentile(acc, 90) < 2.0
    assert np.mean(dist_bg[~on_sphere] < 10.0) > 0.95
    rng = np.random.default_rng(0)
    zs = rng.uniform(-RADIUS, -0.6 * RADIUS, 800)
    phis = rng.uniform(0, 2 * np.pi, 800)
    rr = np.sqrt(RADIUS ** 2 - zs ** 2)
    gt = CENTER + np.stack([rr * np.cos(phis), rr * np.sin(phis), zs], axis=1)
    d2 = ((gt[:, None, :] - points[on_sphere][None, :, :]) ** 2).sum(-1)
    assert float((np.sqrt(d2.min(axis=1)) < 20.0).mean()) > 0.9


def test_gipuma_export_is_byte_identical(session, tmp_path):
    jax_fusion.probability_filter(session, 0.8)
    jax_fusion.mvsnet_to_gipuma(session, str(tmp_path / "jax"))
    assert fusion.main(["--dense_folder", session, "--mode", "gipuma-export"]) == 0
    port_dir = os.path.join(session, "points_mvsnet")
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 4 * 4          # per view: .P, image, disp.dmb, normals.dmb
    for rel in files:
        with open(tmp_path / "jax" / rel, "rb") as a, open(os.path.join(port_dir, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_main_fuses_on_the_cpu(session):
    assert fusion.main(["--dense_folder", session, "--device", "cpu", "--voxel_size", "4",
                        "--min_neighbors", "2"]) == 0
    points, colors = read_ply(os.path.join(session, "points_mvsnet", "consistencyCheck",
                                           "final3d_model.ply"))
    assert len(points) > 100 and np.isfinite(points).all() and colors.shape == (len(points), 3)


def test_fusion_needs_cuda_unless_asked_for_the_cpu(session, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fusion.fuse_session(session)
    with pytest.raises(RuntimeError, match="CUDA"):
        fusion.main(["--dense_folder", session])


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.standard_normal((4000, 3)) * 5.0,
                          rng.uniform(-60, 60, (300, 3))]).astype(np.float32)
    cols = rng.integers(0, 255, (len(pts), 3), dtype=np.uint8)
    return pts, cols


@pytest.mark.parametrize("voxel", [0.5, 2.0])
def test_native_voxel_downsample_matches_jax_and_plain(cloud, voxel):
    pts, cols = cloud
    got = _sorted(*native.voxel_downsample(pts, cols, voxel))
    for want in (jax_native.voxel_downsample(pts, cols, voxel),
                 native.voxel_downsample_plain(pts, cols, voxel)):
        want = _sorted(*want)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    p, c = native.voxel_downsample(pts, None, voxel)
    assert c is None and len(p) == len(got[0])


@pytest.mark.parametrize("min_neighbors", [2, 8])
def test_native_outlier_mask_matches_jax_and_plain(cloud, min_neighbors):
    pts, _ = cloud
    got = native.radius_outlier_removal(pts, 1.5, min_neighbors)
    assert 0 < got.sum() < len(pts)
    np.testing.assert_array_equal(got, jax_native.radius_outlier_removal(pts, 1.5,
                                                                         min_neighbors))
    np.testing.assert_array_equal(got, native.radius_outlier_removal_plain(pts, 1.5,
                                                                           min_neighbors))


def test_native_builds_into_the_build_dir_and_raises_without_a_compiler(tmp_path, monkeypatch):
    lib = native.load()
    assert lib.native_pointcloud_abi_version() == 1
    assert native.build().parent == native.BUILD_DIR
    assert not any(p.suffix == ".so" for p in native.SRC.parent.iterdir())
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_target", lambda name: tmp_path / "_build" / f"{name}.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.voxel_downsample(np.zeros((3, 3), np.float32), None, 1.0)
    monkeypatch.setattr(native, "compiler", lambda name="pointcloud": "false")  # fails
    with pytest.raises(RuntimeError, match="failed"):
        native.radius_outlier_removal(np.zeros((3, 3), np.float32), 1.0, 1)
