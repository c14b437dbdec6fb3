"""The port's checkpoints (`mvsnet_tpu_torch/checkpoint.py`) and the JAX
checkpoint converter (`tools/jax_ckpt_to_torch.py`).

A port checkpoint round-trips bit for bit: parameters, batch-norm
statistics, every optimizer's state and the step, locally and through a
remote (memory://) model dir. A tiny JAX orbax checkpoint ("lite", 64x64,
D=8, float32), converted, gives the port's `Predictor` the JAX
`Predictor`'s depth and prob within 2e-3 / 5e-3 (the tolerances of
`tests/test_torch_models.py`: float32 through ~45 layers in another sum
order), and so does a converted GRU checkpoint. The optimizer state maps slot by slot, equal bit for bit, and one
more update from it equals optax's within 1e-5 (float32 elementwise work
in another order, as `tests/test_torch_train.py` holds the optimizers).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_ckpt_to_torch  # noqa: E402

from mvsnet_tpu import checkpoint as jax_ckpt  # noqa: E402
from mvsnet_tpu import train_lib as jax_train  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.predict import Predictor as JaxPredictor  # noqa: E402
from mvsnet_tpu_torch import checkpoint as ckpt  # noqa: E402
from mvsnet_tpu_torch import train_lib  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.entry import tiny_batch  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.predict import Predictor  # noqa: E402

TINY = dict(view_num=3, max_d=8, width=64, height=64, compute_dtype="float32")


def _trained_state(optimizer, steps=2, seed=0):
    """A port TrainState after `steps` updates with seeded gradients."""
    cfg = ModelConfig(network_mode="ultralite", **TINY)
    tcfg = TrainConfig(optimizer=optimizer)
    model = MVSNet(cfg, seed=seed)
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        train_lib.apply_gradients(state, tcfg)
    with torch.no_grad():
        for b in model.buffers():
            b.add_(torch.rand(b.shape, generator=g))
    return cfg, tcfg, state


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys() and len(oa) > 0
    for i in oa:
        assert oa[i].keys() == ob[i].keys()
        for k in oa[i]:
            assert torch.equal(torch.as_tensor(oa[i][k]), torch.as_tensor(ob[i][k])), (i, k)


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam", "momentum"])
@pytest.mark.parametrize("where", ["local", "memory"])
def test_save_restore_round_trip(tmp_path, optimizer, where):
    cfg, tcfg, state = _trained_state(optimizer)
    base = str(tmp_path / "models") if where == "local" else f"memory://ckpt_{optimizer}"
    path = ckpt.save_checkpoint(base, "3DCNN", "ultralite", 7, state)
    assert path.endswith("7")
    assert ckpt.latest_step(base, "3DCNN", "ultralite") == 7
    _, _, fresh = _trained_state(optimizer, steps=0, seed=1)
    restored = ckpt.restore_checkpoint(base, "3DCNN", "ultralite", fresh)
    assert restored is fresh
    _assert_same_state(restored, state)


def test_latest_step_and_missing(tmp_path):
    base = str(tmp_path / "models")
    assert ckpt.latest_step(base, "3DCNN", "lite") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_tree(base, "3DCNN", "lite")
    _, _, state = _trained_state("rmsprop")
    for step in (3, 12, 5):
        ckpt.save_checkpoint(base, "3DCNN", "lite", step, state)
    os.makedirs(os.path.join(base, "3DCNN", "lite", "notastep"))
    assert ckpt.latest_step(base, "3DCNN", "lite") == 12
    tree = ckpt.restore_tree(base, "3DCNN", "lite")
    assert set(tree) == {"model", "optimizer", "step"} and tree["step"] == 2


@pytest.fixture(scope="module")
def jax_lite(tmp_path_factory):
    """A JAX TrainState of the lite graph (its init, jitted), the inputs and
    the JAX Predictor's depth and prob on them."""
    cfg = JaxModelConfig(network_mode="lite", **TINY)
    model = JaxMVSNet(cfg)
    images, cams, _, _ = tiny_batch(1)
    ds, di = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
    init = jax.jit(lambda key: model.init(key, jnp.asarray(images), jnp.asarray(cams),
                                          ds, di, training=True))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3)))
    # non-identity running statistics, as a trained model has them
    rng = np.random.default_rng(4)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.random(a.shape)).astype(np.float32)
        if str(p[-1].key) == "var" else (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        v["batch_stats"])
    inputs = (images, cams, ds, di, cams[:, 0, 1, 3, 3])
    jp = JaxPredictor(cfg)
    jp.variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    want = [np.asarray(o) for o in jp.predict(*inputs)[:2]]
    return cfg, v, inputs, want


def _jax_state(v, optimizer, grads_seed=None, steps=0):
    """A JAX TrainState over `v` after `steps` optax updates with seeded
    gradients (optax alone, jitted: no model compile), and the next
    gradients."""
    tx = jax_train.make_optimizer(JaxTrainConfig(optimizer=optimizer, stepvalue=3))
    state = jax_train.TrainState.create(apply_fn=None, params=v["params"],
                                        batch_stats=v["batch_stats"], tx=tx)
    rng = np.random.default_rng(grads_seed)
    grads = []
    for _ in range(steps + 1):
        grads.append(jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 10 ** rng.uniform(-4, 0, a.shape))
            .astype(np.float32), v["params"]))
    update = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    for g in grads[:steps]:
        state = update(state, g)
    return state, grads[steps]


def test_converted_checkpoint_predicts_as_jax(jax_lite, tmp_path):
    cfg, v, inputs, (want_depth, want_prob) = jax_lite
    state, _ = _jax_state(v, "rmsprop")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, "3DCNN", "lite", 10, state)
    mcfg = ModelConfig(network_mode="lite", **TINY)
    path = jax_ckpt_to_torch.convert(jax_dir, port_dir, mcfg, TrainConfig())
    assert path == os.path.join(port_dir, "3DCNN", "lite", "10")
    tree = ckpt.restore_tree(port_dir, "3DCNN", "lite", 10)
    assert tree["step"] == 0
    depth, prob, _ = Predictor(mcfg, state_dict=tree["model"], device="cpu").predict(*inputs)
    np.testing.assert_allclose(depth, want_depth, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob, want_prob, rtol=5e-3, atol=5e-3)


def test_converted_gru_checkpoint_predicts_as_jax(tmp_path):
    """A JAX GRU ("lite") checkpoint, converted, restores into the port's
    GRU `Predictor` (no batch statistics), which serves the JAX
    `Predictor`'s depth and prob on the same depth_end within the same
    tolerances."""
    cfg = JaxModelConfig(network_mode="lite", regularization="GRU", **TINY)
    model = JaxMVSNet(cfg)
    images, cams, _, _ = tiny_batch(1)
    ds, di, de = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1], cams[:, 0, 1, 3, 3]
    init = jax.jit(lambda key: model.init(key, jnp.asarray(images), jnp.asarray(cams), ds, di,
                                          method=JaxMVSNet.forward_prob_recurrent))
    v = {"params": jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(5))["params"]),
         "batch_stats": {}}
    state, _ = _jax_state(v, "rmsprop")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, "GRU", "lite", 3, state)
    mcfg = ModelConfig(network_mode="lite", regularization="GRU", **TINY)
    path = jax_ckpt_to_torch.convert(jax_dir, port_dir, mcfg, TrainConfig())
    assert path == os.path.join(port_dir, "GRU", "lite", "3")
    tree = ckpt.restore_tree(port_dir, "GRU", "lite", 3)
    assert any(k.startswith("gru_sweep.gru.conv_gru3.") for k in tree["model"])
    jp = JaxPredictor(cfg)
    jp.variables = v
    inputs = (images, cams, ds, di, de + 0.5)
    want_depth, want_prob = (np.asarray(o) for o in jp.predict(*inputs)[:2])
    depth, prob, _ = Predictor(mcfg, state_dict=tree["model"], device="cpu").predict(*inputs)
    np.testing.assert_allclose(depth, want_depth, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob, want_prob, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam", "momentum"])
def test_converted_optimizer_state(jax_lite, tmp_path, optimizer):
    """Two optax updates, saved by orbax and converted through the CLI:
    every slot equal bit for bit; then one more update on both sides."""
    _, v, _, _ = jax_lite
    state, g = _jax_state(v, optimizer, grads_seed=5, steps=2)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, "3DCNN", "lite", 2, state)
    assert jax_ckpt_to_torch.main(["--model_dir", jax_dir, "--out_dir", port_dir,
                                   "--network_mode", "lite", "--optimizer", optimizer]) == 0
    mcfg = ModelConfig(network_mode="lite", **TINY)
    tcfg = TrainConfig(optimizer=optimizer, stepvalue=3)
    port = train_lib.create_train_state(MVSNet(mcfg), mcfg, tcfg, device="cpu")
    ckpt.restore_checkpoint(port_dir, "3DCNN", "lite", port)
    assert port.step == 2
    names = list(dict(port.model.named_parameters()))
    slots = jax_ckpt_to_torch._SLOTS[optimizer]
    entry = jax_ckpt_to_torch._optax_state(
        jax.tree_util.tree_map(np.asarray, jax_ckpt.restore_tree(jax_dir, "3DCNN", "lite"))
        ["opt_state"], optimizer)
    for field, key in slots.items():
        want = state_dict_from_jax({"params": entry[field]})
        for i, name in enumerate(names):
            assert torch.equal(port.optimizer.state[list(port.model.parameters())[i]][key],
                               want[name]), (field, name)
    # one more update from the converted state, on the same gradients
    named = dict(port.model.named_parameters())
    for name, grad in state_dict_from_jax({"params": g}).items():
        named[name].grad = grad
    train_lib.apply_gradients(port, tcfg)
    new = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, g)
    for name, want in state_dict_from_jax({"params": new.params}).items():
        np.testing.assert_allclose(named[name].detach().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_unmappable_optimizer_state_raises(jax_lite):
    _, v, _, _ = jax_lite
    mcfg = ModelConfig(network_mode="lite", **TINY)
    tree = {"params": v["params"], "batch_stats": v["batch_stats"], "step": 0,
            "opt_state": [{"ema": v["params"]}, {"count": 0}]}
    for optimizer in ("rmsprop", "adam", "momentum"):
        with pytest.raises(ValueError, match="optax"):
            jax_ckpt_to_torch.convert_tree(tree, mcfg, TrainConfig(optimizer=optimizer))
    with pytest.raises(NotImplementedError):
        jax_ckpt_to_torch.convert_tree(tree, mcfg, TrainConfig(optimizer="lamb"))
    adam_for_rmsprop = dict(tree, opt_state=[{"count": 0, "mu": v["params"], "nu": v["params"]}])
    with pytest.raises(ValueError, match="not optax rmsprop"):
        jax_ckpt_to_torch.convert_tree(adam_for_rmsprop, mcfg, TrainConfig())


def test_predictor_takes_jax_constructor_arguments(tmp_path):
    """`Predictor(mcfg, model_dir, ckpt_step, num_devices)` by position, as
    JAX's drivers call it (mvsnet_tpu/predict.py:59, test.py:65-66,
    infer.py:80-81): it restores the port's checkpoint, the given step or
    the latest, and predicts as a keyword call with that checkpoint's state
    dict, bit for bit. A model dir with a state dict, or more devices than
    ranks, raises."""
    cfg, tcfg, state = _trained_state("rmsprop")
    model_dir = str(tmp_path / "m")
    ckpt.save_checkpoint(model_dir, "3DCNN", "ultralite", 3, state)
    for model in state.model.modules():
        for p in model.parameters(recurse=False):
            p.data.add_(1.0)
    ckpt.save_checkpoint(model_dir, "3DCNN", "ultralite", 5, state)
    images, cams = tiny_batch(1)[:2]
    inputs = (images, cams) + tuple(cams[:, 0, 1, 3, i] for i in (0, 1, 3))
    for step in (3, None):
        got = Predictor(cfg, model_dir, step, 1, device="cpu").predict(*inputs)
        sd = ckpt.restore_tree(model_dir, "3DCNN", "ultralite", 5 if step is None else step)
        want = Predictor(cfg, state_dict=sd["model"], device="cpu").predict(*inputs)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    other = Predictor(cfg, model_dir, 3, device="cpu").predict(*inputs)
    assert not np.array_equal(other[0], got[0])
    with pytest.raises(ValueError, match="not both"):
        Predictor(cfg, model_dir, state_dict=sd["model"], device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        Predictor(cfg, model_dir, None, 2, device="cpu")
