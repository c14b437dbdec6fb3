"""The port stands alone: it imports neither JAX nor the JAX package, nor
(at module level) an image codec, fsspec, orbax, matplotlib or
tensorflow, which the card machine lacks; its PNG writers, serving
drivers, TF-checkpoint import, fusion and tools run without them; and it
does not quietly leave the card for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mvsnet_tpu_torch import resolve_device
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.predict import Predictor

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mvsnet_tpu"}
# not on the card machine: imported only inside the functions that need them
LAZY = {"cv2", "imageio", "PIL", "fsspec", "orbax", "matplotlib", "tensorflow"}
PORT_FILES = sorted([p.relative_to(ROOT) for p in (ROOT / "mvsnet_tpu_torch").rglob("*.py")]
                    + [Path("chip_smoke.py")])

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


_NO_CODEC = """
import sys
for name in ("imageio", "cv2", "PIL"):
    sys.modules[name] = None                # any import of them raises ImportError
import numpy as np
from mvsnet_tpu_torch import infer, test
from mvsnet_tpu_torch.io import images

root, session, data = sys.argv[1:4]
rng = np.random.default_rng(0)
depth = rng.uniform(0, 70000, (12, 20)).astype(np.float32)
images.write_depth_png(root + "/d.png", depth)
images.write_confidence_png(root + "/c.png", depth / 70000)
images.write_inverse_depth_png(root + "/i.png", depth)
assert (images.read_png(root + "/d.png") == np.clip(depth, 0, 65535).astype(np.uint16)).all()
assert (images.load_depth_png(root + "/d.png") == images.read_png(root + "/d.png")).all()
argv = ["--view_num", "3", "--max_d", "8", "--width", "64", "--height", "64",
        "--network_mode", "ultralite", "--compute_dtype", "float32", "--device", "cpu",
        "--refinement", "--visualize"]
assert infer.main(["--input_dir", session] + argv) == 0
assert test.main(["--input_dir", data, "--results_path", root + "/r.csv", "--write_output"]
                 + argv) == 0
ref = images.load_image(session + "/depths_mvsnet/0.jpg")
assert ref.ndim == 3 and ref.shape[2] == 3 and ref.dtype == np.uint8
print(sorted(m for m in sys.modules if m.split(".")[0] in ("imageio", "cv2", "PIL")
             and sys.modules[m] is not None))
"""


def test_writers_and_serving_drivers_run_without_a_codec(tmp_path):
    """With imageio, cv2 and PIL blocked, as on the card machine: the PNG
    writers, the port's PNG decoder (the data plane's depth PNGs, written
    by cv2 with filtered rows), and `infer.main` and `test.main` with
    refinement reading the sessions' JPEGs (written by cv2) with the
    port's decoder and writing each reference image `<index>.jpg` with its
    encoder; that JPEG equals what JAX's `load_image` reads."""
    from synthetic_session import make_dataset, make_session

    from mvsnet_tpu.io.images import load_image as jax_load_image

    session = make_session(str(tmp_path / "s"), n_images=3, with_depths=False)
    data = make_dataset(str(tmp_path / "d"), n_sessions=1, split="test", n_images=3)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", _NO_CODEC, str(tmp_path), session, data],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    written = sorted(p.name for p in (tmp_path / "s" / "depths_mvsnet").iterdir())
    assert "0_depth.png" in written and "0.jpg" in written and "0_residual.pfm" in written
    assert (tmp_path / "r.csv").read_text().count("\n") == 2
    from mvsnet_tpu_torch.io.images import load_image
    ref = str(tmp_path / "s" / "depths_mvsnet" / "0.jpg")
    np.testing.assert_array_equal(load_image(ref), jax_load_image(ref))


_BLOCKED = """
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mvsnet_tpu", "cv2", "imageio", "PIL",
           "matplotlib", "tensorflow")
for name in BLOCKED:
    sys.modules[name] = None                # any import of them raises ImportError
import importlib, os, pkgutil
import numpy as np
import torch
import mvsnet_tpu_torch
for m in pkgutil.walk_packages(mvsnet_tpu_torch.__path__, "mvsnet_tpu_torch."):
    importlib.import_module(m.name)
from mvsnet_tpu_torch import fusion, native, tf_import, visualize
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.io import dmb, images, tf_bundle
from mvsnet_tpu_torch.io.cams import write_cam_txt
from mvsnet_tpu_torch.io.pfm import write_pfm
from mvsnet_tpu_torch.io.ply import read_ply
from mvsnet_tpu_torch.models import MVSNet
from mvsnet_tpu_torch.predict import Predictor
from mvsnet_tpu_torch.utils import profiling

root = sys.argv[1]
# TF import: a bundle in the reference's naming -> a model dir -> Predictor
cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, network_mode="ultralite",
                  compute_dtype="float32")
tf_bundle.write_bundle(root + "/tf_model_7.ckpt", tf_import.export_tf_vars(MVSNet(cfg, seed=3)))
tf_import.import_checkpoint(root + "/tf_model_7.ckpt", root + "/model", "3DCNN", "ultralite")
cam = np.zeros((2, 4, 4)); cam[0] = np.eye(4)
cam[1, :3, :3] = [[15, 0, 8], [0, 15, 8], [0, 0, 1]]
with profiling.trace(root + "/trace"):
    depth, prob, _ = Predictor(cfg, root + "/model", 7, device="cpu").predict(
        np.random.default_rng(0).standard_normal((1, 3, 64, 64, 3)), np.stack([cam] * 3)[None],
        [5.0], [0.5], [8.5])
assert np.isfinite(depth).all() and os.listdir(root + "/trace")
# fusion of a fronto-parallel plane seen by three cameras, consolidated natively
out = os.path.join(root, "s", "depths_mvsnet")
os.makedirs(out)
for i in range(3):
    c = np.zeros((2, 4, 4)); c[0] = np.eye(4); c[0, 0, 3] = 25.0 * i  # shifts of whole pixels
    c[1, :3, :3] = [[40, 0, 16], [0, 40, 16], [0, 0, 1]]
    write_cam_txt(f"{out}/{i}.txt", c)
    write_pfm(f"{out}/{i}_init.pfm", np.full((32, 32), 1000.0, np.float32))
    write_pfm(f"{out}/{i}_prob.pfm", np.ones((32, 32), np.float32))
    images.write_image(f"{out}/{i}.jpg", np.full((32, 32, 3), 200, np.uint8))
ply = fusion.fuse_session(os.path.join(root, "s"), num_consistent=2, voxel_size=2.0,
                          min_neighbors=2, device="cpu")
points, colors = read_ply(ply)
assert len(points) > 100 and (colors == 200).all(), len(points)
assert fusion.main(["--dense_folder", os.path.join(root, "s"), "--mode", "gipuma-export"]) == 0
assert visualize.load_depth_any(f"{out}/0_init.pfm").shape == (32, 32)
assert visualize.load_depth_any(root + "/s/points_mvsnet/2333__0/disp.dmb").shape == (32, 32)
# the data tools and the test-and-fuse chain, from a DTU-layout scan to a scored PLY
from mvsnet_tpu_torch.data.synthetic import write_dtu_scan
from mvsnet_tpu_torch.scripts import test_and_fuse
from mvsnet_tpu_torch.tools import convert_dtu, dtu_fixer, eval_pointcloud, split_data
write_dtu_scan(root + "/dtu", width=64, height=64, n_views=4, n_lightings=2, workers=2)
convert_dtu.convert_dtu(root + "/dtu", root + "/sessions", num_views=4, num_lightings=2)
assert dtu_fixer.main([root + "/sessions"]) == 0
assert split_data.main([root + "/sessions", "--train", "0.5", "--val", "0", "--test", "0.5"]) == 0
assert test_and_fuse.main(["--test_folder_root", root + "/sessions/test", "--device", "cpu",
                           "--prob_threshold", "0", "--num_consistent", "1",
                           "--ply_folder", root + "/plys", "--results_path", root + "/f.csv",
                           "--infer_args", "--view_num", "3", "--max_d", "8", "--width", "64",
                           "--height", "64", "--network_mode", "ultralite",
                           "--compute_dtype", "float32"]) == 0
(run,) = os.listdir(root + "/plys")
(ply,) = os.listdir(os.path.join(root, "plys", run))
ply = os.path.join(root, "plys", run, ply)
assert len(read_ply(ply)[0]) > 0
assert eval_pointcloud.main(["--pred", ply, "--gt", ply]) == 0
print(sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None))
"""


def test_new_modules_run_with_jax_codecs_matplotlib_and_tensorflow_blocked(tmp_path):
    """Slice 5b's modules (TF import, fusion with its native library,
    visualize, profiling) and the data tools and test-and-fuse chain (a
    DTU-layout scan converted, fixed, split, served, fused and scored)
    import and run with jax, the JAX package, cv2, imageio, PIL,
    matplotlib and tensorflow blocked; every JPEG goes through the port's
    codec."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED, str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_import_and_cpu_forward_load_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE % (FORBIDDEN | LAZY,)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def _module_level(tree):
    """The statements that run when the module is imported: everything
    outside function bodies (class bodies, ifs and trys included)."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_FILES, ids=str)
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for name in _imports(ast.walk(tree)):
        assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=str)
def test_source_imports_no_codec_at_module_level(path):
    tree = ast.parse((ROOT / path).read_text())
    for name in _imports(_module_level(tree)):
        assert name.split(".")[0] not in LAZY, f"{path} imports {name} at module level"


def test_only_the_converter_imports_both_packages():
    """Outside the tests, one file imports both the JAX package and the
    port: the checkpoint converter, which runs where JAX is installed."""
    both = []
    paths = list(ROOT.glob("*.py"))
    for d in ("mvsnet_tpu", "mvsnet_tpu_torch", "tools", "scripts"):
        paths += (ROOT / d).rglob("*.py")
    for path in sorted(paths):
        roots = {n.split(".")[0] for n in _imports(ast.walk(ast.parse(path.read_text())))}
        if {"mvsnet_tpu", "mvsnet_tpu_torch"} <= roots:
            both.append(str(path.relative_to(ROOT)))
    assert both == ["tools/jax_ckpt_to_torch.py"]


def test_default_device_needs_cuda(monkeypatch):
    """device=None means the card: without CUDA it raises, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(ModelConfig(network_mode="ultralite", max_d=8, width=64, height=64))
    assert resolve_device("cpu") == torch.device("cpu")
