"""TF-checkpoint import in the port (`io/tf_bundle.py`, `tf_import.py`)
against the JAX package's (`mvsnet_tpu/io/tf_bundle.py`,
`mvsnet_tpu/tf_import.py`) on the CPU.

- Bundles: each package reads what the other writes (every dtype, bf16,
  more entries than a restart interval), and both refuse the same broken
  files.
- TF names: every state-dict entry of each configuration maps to the TF
  names and layout JAX gives its flax path (exactly).
- Import: one Saver V2 bundle in the reference's naming, written by the
  port from a seeded model, fills the JAX tree and the port's state dict
  with the same bits; the port restores the seeded weights bit for bit;
  a forward of the imported weights agrees with JAX's within the golden
  fixture's tolerances (depth 2e-3, prob 5e-3, tests/test_golden.py); and
  `import_checkpoint` makes a model dir that `Predictor` serves.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import ml_dtypes

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import tiny_inputs  # noqa: E402
from test_torch_refine import seeded_variables  # noqa: E402

from mvsnet_tpu import tf_import as jax_tf_import  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.io import tf_bundle as jax_bundle  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.models import refine as jax_refine  # noqa: E402
from mvsnet_tpu_torch import checkpoint, tf_import  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.io import tf_bundle  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet, refine  # noqa: E402
from mvsnet_tpu_torch.predict import Predictor  # noqa: E402

TINY = dict(view_num=3, max_d=8, width=64, height=64, compute_dtype="float32")
_WRAPPERS = {"Conv_0", "ConvTranspose_0", "BatchNorm_0"}
# (regularization, network_mode, refinement options): the configurations
# whose names the import covers
CONFIGS = {
    "3dcnn_normal": ("3DCNN", "normal", {}),
    "3dcnn_lite": ("3DCNN", "lite", {}),
    "3dcnn_ultralite": ("3DCNN", "ultralite", {}),
    "refine_net_conv": ("3DCNN", "ultralite", dict(refinement=True)),
    "refine_unet_conv": ("3DCNN", "ultralite",
                         dict(refinement=True, refinement_network="unet",
                              refine_with_confidence=True)),
    "gru_normal": ("GRU", "normal", {}),
}


# ---------------------------------------------------------------- bundles


def _tensors(rng):
    return {
        "conv0_0/kernel": rng.standard_normal((3, 3, 3, 8)).astype(np.float32),
        "conv0_0/bias": rng.standard_normal((8,)).astype(np.float32),
        "global_step": np.asarray(150000, np.int64),
        "flags": np.asarray([True, False, True]),
        "half": rng.standard_normal((4, 5)).astype(np.float16),
        "dbl": rng.standard_normal((2, 2)).astype(np.float64),
        "i32": np.arange(7, dtype=np.int32),
        "u8": rng.integers(0, 255, (3, 4), dtype=np.uint8),
        "u16": rng.integers(0, 65535, (6,), dtype=np.uint16),
        "i8": rng.integers(-100, 100, (5,), dtype=np.int8),
        "i16": rng.integers(-3000, 3000, (5,), dtype=np.int16),
        "u32": rng.integers(0, 2 ** 31, (2,), dtype=np.uint32),
        "u64": rng.integers(0, 2 ** 62, (2,), dtype=np.uint64),
        "bf16": np.asarray([[1.5, -2.25], [0.0, 3.0]], ml_dtypes.bfloat16),
        # more than one restart interval of shared key prefixes
        **{f"net/layer{i:02d}/kernel": rng.standard_normal((3, i + 1)).astype(np.float32)
           for i in range(40)},
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bundles_cross_read(tmp_path, writer):
    tensors = _tensors(np.random.default_rng(0))
    prefix = str(tmp_path / "tf_model_42.ckpt")
    write, read = ((tf_bundle.write_bundle, jax_bundle.read_bundle) if writer == "port"
                   else (jax_bundle.write_bundle, tf_bundle.read_bundle))
    write(prefix, tensors)
    got = read(prefix, verify="all")
    raw = read(prefix, dtype_policy="raw")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        if k == "bf16":
            assert got[k].dtype == np.float32 and raw[k].dtype == np.uint16
            np.testing.assert_array_equal(got[k], v.astype(np.float32))
            np.testing.assert_array_equal(raw[k], v.view(np.uint16))
            continue
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v)
    assert tf_bundle.is_bundle(prefix) and jax_bundle.is_bundle(prefix)


def test_bundle_files_are_the_same_bytes(tmp_path):
    tensors = _tensors(np.random.default_rng(1))
    tf_bundle.write_bundle(str(tmp_path / "port"), tensors)
    jax_bundle.write_bundle(str(tmp_path / "jax"), tensors)
    for suffix in (".index", ".data-00000-of-00001"):
        assert ((tmp_path / f"port{suffix}").read_bytes()
                == (tmp_path / f"jax{suffix}").read_bytes())
    data = os.urandom(1000)
    assert tf_bundle.crc32c(data) == jax_bundle.crc32c(data)
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283


def _corrupt_index(prefix):
    with open(prefix + ".index", "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 0xFF]))


def _bad_magic(prefix):
    with open(prefix + ".index", "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\x00" * 8)


def _corrupt_payload(prefix):
    with open(prefix + ".data-00000-of-00001", "r+b") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("damage,verify,match", [
    (_corrupt_index, "index", "crc mismatch"),
    (_bad_magic, "index", "magic"),
    (_corrupt_payload, "all", "payload crc"),
])
def test_broken_bundles_raise_alike(tmp_path, damage, verify, match):
    prefix = str(tmp_path / "m.ckpt")
    tf_bundle.write_bundle(prefix, {"a/kernel": np.arange(12, dtype=np.float32),
                                    "b/bias": np.ones(3, np.float32)})
    damage(prefix)
    for read in (tf_bundle.read_bundle, jax_bundle.read_bundle):
        with pytest.raises(ValueError, match=match):
            read(prefix, verify=verify)
    if damage is _corrupt_payload:           # the default checks the index only
        tf_bundle.read_bundle(prefix)


# ---------------------------------------------------------------- TF names


def _jax_paths(name):
    """(flax path, leaf shape) of every variable of configuration `name`,
    from `jax.eval_shape` of the init (no compile)."""
    reg, mode, extra = CONFIGS[name]
    model = JaxMVSNet(JaxModelConfig(network_mode=mode, regularization=reg, **TINY, **extra))
    images, cams, ds, di = tiny_inputs()
    if reg == "GRU":
        init = lambda k: model.init(k, images, cams, ds, di, training=True)  # noqa: E731
    else:
        init = lambda k: model.init(k, images, cams, ds, di)  # noqa: E731
    return jax.eval_shape(init, jax.random.PRNGKey(0))


def _port_model(name):
    reg, mode, extra = CONFIGS[name]
    return MVSNet(ModelConfig(network_mode=mode, regularization=reg, **TINY, **extra))


def _standalone_refine(cls):
    """A refinement net not built by MVSNet (the norm editions), as the
    port's model would hold it under `refine_net`."""
    color = np.zeros((1, 32, 48, 3), np.float32)
    data = np.zeros((1, 32, 48, 2), np.float32)
    shapes = jax.eval_shape(lambda k: getattr(jax_refine, cls)("lite").init(k, color, data),
                            jax.random.PRNGKey(0))
    port = torch.nn.Module()
    port.refine_net = getattr(refine, cls)(5, "lite")
    shapes = {coll: {"refine_net": tree} for coll, tree in shapes.items()}
    return shapes, port


def _check_names(variables, port):
    state = port.state_dict()
    transposed = tf_import.transposed_kernels(port)
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    names = []
    probe = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    for path, leaf in leaves:
        keys = [str(getattr(k, "key", k)) for k in path]
        name = ".".join(k for k in keys[1:] if k not in _WRAPPERS)
        names.append(name)
        want, want_t = jax_tf_import.flax_path_to_tf_name(path)
        got, got_t = tf_import.tf_name_candidates(name, name in transposed)
        assert got == want, name
        np.testing.assert_array_equal(got_t(probe), want_t(probe), err_msg=name)
        assert tuple(state[name].shape) == tuple(leaf.shape), name
    assert sorted(names) == sorted(state)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tf_names_match_jax(name):
    _check_names(_jax_paths(name), _port_model(name))


@pytest.mark.parametrize("cls", ["RefineNet", "RefineUNet"])
def test_tf_names_match_jax_norm_refine_nets(cls):
    _check_names(*_standalone_refine(cls))


# ---------------------------------------------------------------- import


def _seeded_port_model(name, seed):
    """The configuration's port model with every entry seeded
    (tests/test_torch_refine.py's distributions: non-identity norms)."""
    model = _port_model(name)
    shapes = jax.tree_util.tree_map(lambda v: v, _jax_paths(name))
    model.load_state_dict(state_dict_from_jax(seeded_variables(shapes, seed)))
    return model, shapes


@pytest.fixture(scope="module", params=["refine_unet_conv", "gru_normal"])
def imported(request, tmp_path_factory):
    """A bundle in the reference's naming from a seeded port model, read
    and imported by both packages."""
    name = request.param
    model, shapes = _seeded_port_model(name, 11)
    tf_vars = tf_import.export_tf_vars(model)
    # optimizer slots and the step travel in reference checkpoints
    tf_vars["2dconv1_0/kernel/Adam"] = np.zeros_like(tf_vars["2dconv1_0/kernel"])
    tf_vars["global_step"] = np.asarray(150000, np.int64)
    prefix = str(tmp_path_factory.mktemp(name) / "tf_model_150000.ckpt")
    tf_bundle.write_bundle(prefix, tf_vars)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jax_filled = jax_tf_import.import_tf_vars(jax_tf_import.load_tf_checkpoint(prefix),
                                              template)
    port_filled = tf_import.import_tf_vars(tf_import.load_tf_checkpoint(prefix), model)
    return name, model, prefix, tf_vars, jax_filled, port_filled


def test_import_matches_jax_bit_for_bit(imported):
    name, model, _, tf_vars, jax_filled, port_filled = imported
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_filled))
    assert sorted(want) == sorted(port_filled)
    seeded = model.state_dict()
    for k, v in port_filled.items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, seeded[k]), k
    if name == "gru_normal":       # the standard widths' layer-norm spelling
        assert "conv_gru2/Gates/LayerNorm_1/gamma" in tf_vars
    else:                          # a transposed kernel in TF's (..., out, in) layout
        k = seeded["refine_net.2dconv5_0_refine.kernel"].numpy()
        np.testing.assert_array_equal(tf_vars["2dconv5_0_refine/kernel"], np.swapaxes(k, -1, -2))
        assert "2dconv1_0/kernel" in tf_vars and "3dconv1_0/bn/moving_mean" in tf_vars


def test_import_strict_and_optimizer_slots(imported, caplog):
    _, model, _, tf_vars, _, _ = imported
    partial = {k: v for k, v in tf_vars.items() if not k.startswith("2dconv1_0/")}
    with pytest.raises(KeyError, match="not found"):
        tf_import.import_tf_vars(partial, model)
    loose = tf_import.import_tf_vars(partial, model, strict=False)
    assert torch.equal(loose["feature_net.2dconv1_0.conv.kernel"],
                       model.state_dict()["feature_net.2dconv1_0.conv.kernel"])
    caplog.clear()
    with caplog.at_level("WARNING", logger="mvsnet_tpu_torch.tf_import"):
        same = tf_import.import_tf_vars(tf_vars, model.state_dict(),
                                        transposed=tf_import.transposed_kernels(model))
    assert "unused" not in caplog.text          # Adam slot and global_step are filtered
    for k, v in model.state_dict().items():      # a state dict and its names as the model
        assert torch.equal(same[k], v), k
    bad = dict(tf_vars, **{"2dconv1_0/kernel": np.zeros((1, 2), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tf_import.import_tf_vars(bad, model)


def test_imported_forward_matches_jax(imported):
    """One forward of the imported weights at 64x64, D=8: the JAX graph
    on JAX's import against the port's on the port's."""
    name, model, _, _, jax_filled, port_filled = imported
    reg, mode, extra = CONFIGS[name]
    images, cams, ds, di = tiny_inputs()
    cams = np.array(cams)
    cams[0, 1, 0, 0, 3] += 0.4
    cams[0, 2, 0, 1, 3] -= 0.3
    de = cams[:, 0, 1, 3, 3].copy()
    jcfg = JaxModelConfig(network_mode=mode, regularization=reg, **TINY, **extra)
    from mvsnet_tpu.predict import Predictor as JaxPredictor
    jp = JaxPredictor(jcfg)
    jp.variables = jax_filled
    want = jp.predict(np.array(images), cams, np.array(ds), np.array(di), de)
    got = Predictor(ModelConfig(network_mode=mode, regularization=reg, **TINY, **extra),
                    state_dict=port_filled, device="cpu").predict(
        np.array(images), cams, np.array(ds), np.array(di), de)
    for w, g, tol in zip(want, got, (2e-3, 5e-3, 2e-3)):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


def test_import_checkpoint_serves(imported, tmp_path):
    """`import_checkpoint` writes the port's checkpoint layout at the
    reference name's step; `Predictor(mcfg, model_dir, ckpt_step)` serves
    it as it serves the seeded weights, bit for bit; training does not
    resume from it."""
    name, model, prefix, _, _, port_filled = imported
    reg, mode, extra = CONFIGS[name]
    out = tf_import.import_checkpoint(prefix, str(tmp_path), reg, mode, **extra)
    assert out == os.path.join(str(tmp_path), reg, mode, "150000")
    tree = checkpoint.restore_tree(str(tmp_path), reg, mode, 150000)
    assert sorted(tree) == ["model", "step"] and tree["step"] == 150000
    for k, v in tree["model"].items():
        assert torch.equal(v, port_filled[k]), k
    cfg = ModelConfig(network_mode=mode, regularization=reg, **TINY, **extra)
    images, cams, ds, di = tiny_inputs()
    args = (np.array(images), np.array(cams), np.array(ds), np.array(di),
            np.array(cams)[:, 0, 1, 3, 3])
    served = Predictor(cfg, str(tmp_path), 150000, device="cpu").predict(*args)
    seeded = Predictor(cfg, state_dict=model.state_dict(), device="cpu").predict(*args)
    for a, b in zip(served, seeded):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="training cannot resume"):
        from mvsnet_tpu_torch import train_lib
        from mvsnet_tpu_torch.config import TrainConfig
        state = train_lib.create_train_state(MVSNet(cfg), cfg, TrainConfig(), device="cpu")
        checkpoint.restore_checkpoint(str(tmp_path), reg, mode, state, 150000)


def test_import_checkpoint_step_from_npz_name(tmp_path):
    model, _ = _seeded_port_model("3dcnn_ultralite", 12)
    npz = str(tmp_path / "tf_model_19307.ckpt.npz")
    np.savez(npz, **tf_import.export_tf_vars(model))
    out = tf_import.import_checkpoint(npz, str(tmp_path / "m"), "3DCNN", "ultralite")
    assert out.endswith(os.path.join("ultralite", "19307"))
    restored = checkpoint.restore_tree(str(tmp_path / "m"), "3DCNN", "ultralite")["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(restored[k], v), k
