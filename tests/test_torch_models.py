"""The port's layers, towers and 3D-CNN graph against the JAX package on the
CPU: weights from the JAX model's own init (PRNGKey(7), as the golden
fixture), turned into the port's state dict by `convert.py`.

Tolerances: the golden fixture's own (depth 2e-3, prob 5e-3,
tests/test_golden.py); layer outputs 1e-4 absolute and relative, float32
sums in another order through a dozen to thirty layers.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import GOLDEN, tiny_inputs  # noqa: E402

from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.models.feature_net import UNetDS2GN as JaxUNetDS2GN  # noqa: E402
from mvsnet_tpu.models.layers import group_norm_core as jax_group_norm  # noqa: E402
from mvsnet_tpu.models.regnet import RegNetUS0 as JaxRegNetUS0  # noqa: E402
from mvsnet_tpu.predict import Predictor as JaxPredictor  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.models.layers import group_norm_core  # noqa: E402
from mvsnet_tpu_torch.predict import Predictor, depth_params_from_cams  # noqa: E402

TINY = dict(view_num=3, max_d=8, width=64, height=64, compute_dtype="float32")


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def golden_weights():
    """JAX init of the golden fixture's 3D-CNN model (ultralite)."""
    cfg = JaxModelConfig(network_mode="ultralite", **TINY)
    images, cams, ds, di = tiny_inputs()
    v = JaxMVSNet(cfg).init(jax.random.PRNGKey(7), images, cams, ds, di,
                            method=JaxMVSNet.forward_3dcnn)
    return _numpy_tree(v)


def _perturb(variables, seed):
    """Non-identity norms: random GN/BN scale and bias, BN running stats."""
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in variables.items():
        def f(path, leaf):
            name = str(getattr(path[-1], "key", path[-1]))
            if name in ("scale", "var"):
                return (0.5 + rng.random(leaf.shape)).astype(np.float32)
            if name in ("bias", "mean"):
                return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
            return leaf
        out[coll] = jax.tree_util.tree_map_with_path(f, tree)
    return out


def _scene(H=64, W=64, D=8):
    """Three views with a baseline, so the cost volume is not trivial:
    images, cams, depth start, interval and end (`Predictor.predict`'s
    arrays)."""
    images, cams, ds, di = tiny_inputs(H=H, W=W, D=D)
    cams = np.array(cams)
    cams[0, 1, 0, 0, 3] += 0.4
    cams[0, 2, 0, 1, 3] -= 0.3
    return np.array(images), cams, np.array(ds), np.array(di), cams[:, 0, 1, 3, 3].copy()


@pytest.fixture(scope="module")
def lite_model():
    """JAX `lite` model with perturbed norms, and its forward on `_scene`."""
    cfg = JaxModelConfig(network_mode="lite", **TINY)
    images, cams, ds, di, de = _scene()
    model = JaxMVSNet(cfg)
    v = _perturb(_numpy_tree(model.init(jax.random.PRNGKey(7), images, cams, ds, di,
                                        method=JaxMVSNet.forward_3dcnn)), 11)
    depth, prob = model.apply(v, images, cams, ds, di, method=JaxMVSNet.forward_3dcnn)
    return v, (images, cams, ds, di, de), (np.asarray(depth), np.asarray(prob))


def test_convert_covers_every_tensor(golden_weights):
    sd = state_dict_from_jax(golden_weights)
    model = MVSNet(ModelConfig(network_mode="ultralite", **TINY))
    assert set(sd) == set(model.state_dict())
    assert "feature_net.2dconv5_0.deconv.kernel" in sd
    assert "regnet.3dconv1_0.bn.var" in sd
    model.load_state_dict(sd)                      # strict: shapes match too


def test_forward_3dcnn_matches_golden(golden_weights):
    cfg = ModelConfig(network_mode="ultralite", **TINY)
    p = Predictor(cfg, state_dict=state_dict_from_jax(golden_weights), device="cpu")
    images, cams, ds, di = tiny_inputs()
    de = depth_params_from_cams(np.array(cams))[3]
    depth, prob, residual = p.predict(np.array(images), np.array(cams), np.array(ds),
                                      np.array(di), de)
    data = np.load(GOLDEN)
    np.testing.assert_allclose(depth, data["3DCNN_depth"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob, data["3DCNN_prob"], rtol=5e-3, atol=5e-3)
    assert not residual.any()


def test_group_norm_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 2, 1e-5)
    got = group_norm_core(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
                          2, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_feature_net_matches_jax(lite_model):
    v, (images, *_), _ = lite_model
    flat = images.reshape(3, 64, 64, 3)
    want = JaxUNetDS2GN("lite", dtype="float32").apply(
        {"params": v["params"]["feature_net"]}, flat)
    model = MVSNet(ModelConfig(network_mode="lite", **TINY))
    model.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got = model.feature_net(torch.from_numpy(flat))
    assert got.shape == (3, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_regnet_matches_jax(lite_model):
    """Folded eval batch norms (non-identity running stats), the deconvs
    and the additive skips."""
    v, *_ = lite_model
    cost = (np.random.default_rng(9).random((1, 8, 16, 16, 16)) * 2).astype(np.float32)
    want = JaxRegNetUS0("lite", dtype="float32").apply(
        {"params": v["params"]["regnet"], "batch_stats": v["batch_stats"]["regnet"]},
        cost, False)
    model = MVSNet(ModelConfig(network_mode="lite", **TINY))
    model.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got = model.regnet(torch.from_numpy(cost))
    assert got.shape == (1, 8, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_forward_3dcnn_matches_jax(lite_model):
    v, inputs, (want_depth, want_prob) = lite_model
    p = Predictor(ModelConfig(network_mode="lite", **TINY),
                  state_dict=state_dict_from_jax(v), device="cpu")
    depth, prob, _ = p.predict(*inputs)
    np.testing.assert_allclose(depth, want_depth, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob, want_prob, rtol=5e-3, atol=5e-3)


def test_predict_takes_jax_arguments(lite_model):
    """`Predictor.predict` has JAX's signature (mvsnet_tpu/predict.py:139):
    five arrays by position, depth_end last, then `fetch`. Such a call with
    fetch=False gives the JAX Predictor's maps on the same weights; a call
    with four arrays leaves depth_end out and raises."""
    v, inputs, _ = lite_model
    cfg = dict(network_mode="lite", **TINY)
    p = Predictor(ModelConfig(**cfg), state_dict=state_dict_from_jax(v), device="cpu")
    depth, prob, residual = p.predict(*inputs, fetch=False)
    assert all(torch.is_tensor(t) for t in (depth, prob, residual))
    jp = JaxPredictor(JaxModelConfig(**cfg))
    jp.variables = v
    want = jp.predict(*inputs, fetch=False)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want[0]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want[1]), rtol=5e-3, atol=5e-3)
    with pytest.raises(TypeError):
        p.predict(*inputs[:4])


def test_seeded_weights_are_reproducible():
    cfg = ModelConfig(network_mode="ultralite", **TINY)
    inputs = _scene()
    a = Predictor(cfg, seed=3, device="cpu").predict(*inputs)
    b = Predictor(cfg, seed=3, device="cpu").predict(*inputs)
    c = Predictor(cfg, seed=4, device="cpu").predict(*inputs)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[1], c[1])
    assert np.isfinite(a[0]).all() and np.isfinite(a[1]).all()


@pytest.mark.parametrize("kw,exc", [
    (dict(refinement=True), NotImplementedError),
    (dict(regularization="GRU", refinement=True), NotImplementedError),
])
def test_unported_graphs_raise(kw, exc):
    """Refinement, on either regularizer, waits for its slice of the port
    (the GRU graphs are ported: tests/test_torch_gru.py)."""
    with pytest.raises(exc):
        Predictor(ModelConfig(network_mode="ultralite", **TINY, **kw), device="cpu")


def test_shape_check_raises():
    """Feature width 48/4 = 12 is not divisible by 8."""
    inputs = _scene(W=48)
    p = Predictor(ModelConfig(network_mode="ultralite", **TINY), device="cpu")
    with pytest.raises(ValueError, match="feature width=12"):
        p.predict(*inputs)


def test_depth_params_from_cams():
    cams = _scene()[1]
    ds, di, dn, de = depth_params_from_cams(cams)
    assert (ds.tolist(), di.tolist(), dn, de.tolist()) == ([5.0], [0.5], 8, [8.5])
