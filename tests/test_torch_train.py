"""The port's 3D-CNN training path on the CPU against the JAX package, on the
same numpy inputs: batch norm in training mode against flax, the losses
against `mvsnet_tpu.losses`, the optimizers against optax, and one full
`make_train_step` against JAX's (`ultralite`, 64x64, D=8, V=3, float32;
weights from the JAX model's own init, norms perturbed).

Tolerances: elementwise float32 work (losses, optimizer updates, batch-norm
outputs and statistics) 1e-5 absolute and relative, float32 in another
order. The full step runs some 45 layers and the cost volume forward and
backward in float32, with sums in another order (PyTorch's CPU convs
against XLA's): the loss to 1e-4 relative; each gradient leaf to 1e-3 of
its own largest entry (2e-4 seen); the new running statistics to 1e-4.
The first RMSprop update, g / sqrt(0.1 g^2 + 1e-10) times lr, is about
lr * sqrt(10) = 3.2e-3 in size wherever |g| >> 3e-5 and changes up to 100
times faster than g near |g| = 3e-5, so a gradient that agrees to 1e-3
of its leaf can move one parameter by a few 1e-4: every updated parameter
within 1e-3, and all but 0.1 % of them within 1e-5 (0.02 % seen).
"""

import dataclasses
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import tiny_inputs  # noqa: E402

from mvsnet_tpu import losses as jax_losses  # noqa: E402
from mvsnet_tpu import train_lib as jax_train  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.models.layers import BatchNormRef as JaxBatchNorm  # noqa: E402
from mvsnet_tpu_torch import losses, train_lib  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.models.layers import BatchNormRef  # noqa: E402

ELEM = dict(atol=1e-5, rtol=1e-5)
TINY = dict(view_num=3, max_d=8, width=64, height=64, compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 16), (3, 10, 12, 8)])
def test_batch_norm_training_matches_flax(shape):
    """Batch statistics (biased variance), the output, its gradients and the
    running update 0.99 * running + 0.01 * batch."""
    rng = np.random.default_rng(0)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = (0.5 + rng.random(C)).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    mean0 = rng.standard_normal(C).astype(np.float32)
    var0 = (0.5 + rng.random(C)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    params = {"BatchNorm_0": {"scale": scale, "bias": bias}}
    stats = {"BatchNorm_0": {"mean": mean0, "var": var0}}

    def f(xx, p):
        return JaxBatchNorm().apply({"params": p, "batch_stats": stats}, xx, True,
                                    mutable=["batch_stats"])
    (y, new), vjp = jax.vjp(f, jnp.asarray(x), params)
    dx, dp = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like, new)))

    bn = BatchNormRef(C).train()
    bn.load_state_dict({"scale": _t(scale), "bias": _t(bias), "mean": _t(mean0),
                        "var": _t(var0)})
    xt = _t(x).requires_grad_()
    out = bn(xt)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **ELEM)
    np.testing.assert_allclose(bn.mean.numpy(), new["batch_stats"]["BatchNorm_0"]["mean"],
                               **ELEM)
    np.testing.assert_allclose(bn.var.numpy(), new["batch_stats"]["BatchNorm_0"]["var"],
                               **ELEM)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bn.scale.grad.numpy(), dp["BatchNorm_0"]["scale"],
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), dp["BatchNorm_0"]["bias"],
                               atol=1e-3, rtol=1e-4)
    # eval: the running statistics, the same affine the eval convs fold in
    scale_e, shift_e = bn.affine()
    with torch.no_grad():
        np.testing.assert_allclose(bn.eval()(xt).numpy(), (xt * scale_e + shift_e).numpy(),
                                   atol=1e-5, rtol=1e-5)


def _depth_pair(seed, B=2, H=12, W=10):
    rng = np.random.default_rng(seed)
    y_true = rng.uniform(425.0, 900.0, (B, H, W, 1)).astype(np.float32)
    y_true[:, :2] = 0.0                                  # invalid rows
    y_pred = (y_true + rng.standard_normal(y_true.shape) * 4.0).astype(np.float32)
    start = np.array([425.0, 430.0], np.float32)[:B]
    end = start + 191 * 2.5
    return y_true, y_pred, start, end


@pytest.mark.parametrize("loss_type,grad_loss", [
    ("original", False), ("power", True), ("power", False), ("gaussian", True),
])
def test_regression_loss_matches_jax(loss_type, grad_loss):
    y_true, y_pred, start, end = _depth_pair(1)
    kw = dict(loss_type=loss_type, alpha=0.25, beta=0.0, eta=0.02, grad_loss=grad_loss)
    (want, aux), vjp = jax.vjp(
        lambda p: (lambda r: (r[0], r[1:]))(jax_losses.mvsnet_regression_loss(
            p, jnp.asarray(y_true), jnp.asarray(start), jnp.asarray(end), **kw)),
        jnp.asarray(y_pred))
    (want_grad,) = vjp((jnp.ones(()), jax.tree_util.tree_map(jnp.zeros_like, aux)))
    pred = _t(y_pred).requires_grad_()
    loss, l1, l3, debug = losses.mvsnet_regression_loss(pred, _t(y_true), _t(start),
                                                        _t(end), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose([l1.item(), l3.item(), debug.item()],
                               [float(a) for a in aux], **ELEM)
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=1e-4)


def test_power_loss_with_beta_matches_jax():
    y_true, y_pred, start, end = _depth_pair(2)
    interval = (end - start) / 191.0
    want = jax_losses.power_loss(jnp.asarray(y_true), jnp.asarray(y_pred),
                                 jnp.asarray(interval), 0.5, 1.0)
    got = losses.power_loss(_t(y_true), _t(y_pred), _t(interval), 0.5, 1.0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 35000, 70000, 140001])
def test_lr_schedule_matches_optax(step):
    want = float(jax_train.lr_schedule(JaxTrainConfig())(step))
    np.testing.assert_allclose(train_lib.lr_schedule(TrainConfig(), step), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["rmsprop", "momentum", "adam"])
def test_optimizer_matches_optax(name):
    """Four updates with the schedule's rate (stepvalue 2, so it decays)
    on the same gradients."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10 ** rng.uniform(-6, 0, v.shape))
              .astype(np.float32) for k, v in params.items()} for _ in range(4)]
    jcfg = JaxTrainConfig(optimizer=name, stepvalue=2)
    tx = jax_train.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    model = torch.nn.Module()
    for k, v in tp.items():
        model.register_parameter(k, v)
    tcfg = TrainConfig(optimizer=name, stepvalue=2)
    state = train_lib.TrainState(model, train_lib.make_optimizer(tcfg, model.parameters()))
    for g in grads:
        for k, v in tp.items():
            v.grad = _t(g[k])
        train_lib.apply_gradients(state, tcfg)
    assert state.step == 4
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), **ELEM)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _perturb(variables, seed):
    """Non-identity norms and running statistics."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "var"):
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return {c: jax.tree_util.tree_map_with_path(f, t) for c, t in variables.items()}


def _train_batch():
    images, cams, _, _ = tiny_inputs()
    cams = np.array(cams, np.float32)
    cams[0, 1, 0, 0, 3] += 0.4
    cams[0, 2, 0, 1, 3] -= 0.3
    rng = np.random.default_rng(5)
    gt = rng.uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    gt[0, :3] = 0.0
    return np.array(images, np.float32), cams, gt, gt


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step: the perturbed initial variables, the gradients,
    the new batch statistics, the metrics and the updated state."""
    cfg = JaxModelConfig(network_mode="ultralite", **TINY)
    tcfg = JaxTrainConfig()
    model = JaxMVSNet(cfg)
    batch = _train_batch()
    images, cams = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    ds, di, _ = jax_train.batch_depth_params(cams)
    # create_train_state's init, jitted (eager init takes ~30 s on the CPU)
    init = jax.jit(lambda key: model.init(key, images, cams, ds, di, training=True))
    v = _perturb(_numpy_tree(init(jax.random.PRNGKey(7))), 11)
    state = jax_train.TrainState.create(apply_fn=model.apply, params=v["params"],
                                        batch_stats=v["batch_stats"],
                                        tx=jax_train.make_optimizer(tcfg))

    def loss_fn(p):
        return jax_train.compute_loss(model, cfg, tcfg, p, state.batch_stats, batch, True)
    grads, (new_stats, metrics) = jax.jit(jax.grad(loss_fn, has_aux=True))(state.params)
    new_state = state.apply_gradients(grads=grads, batch_stats=new_stats)
    return v, _numpy_tree(grads), _numpy_tree(new_stats), metrics, new_state, batch


def test_train_step_matches_jax(jax_step):
    v, grads, new_stats, metrics, new_state, batch = jax_step
    cfg = ModelConfig(network_mode="ultralite", **TINY)
    tcfg = TrainConfig()
    model = MVSNet(cfg)
    model.load_state_dict(state_dict_from_jax(v))
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    step = train_lib.make_train_step(model, cfg, tcfg)
    state, got = step(state, batch)
    assert state.step == 1

    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    for k in ("less_one", "less_three"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), atol=1e-6)

    want_grads = state_dict_from_jax({"params": grads})
    named = dict(model.named_parameters())
    assert set(want_grads) == set(named)
    for name, want in want_grads.items():
        g = named[name].grad
        assert g is not None, name
        scale = max(float(want.abs().max()), 1e-12)
        err = float((g - want).abs().max())
        assert err <= 1e-3 * scale, f"{name}: max err {err:.3e}, max |grad| {scale:.3e}"

    want_stats = state_dict_from_jax({"batch_stats": new_stats})
    buffers = dict(model.named_buffers())
    assert set(want_stats) == set(buffers)
    for name, want in want_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)

    want_params = state_dict_from_jax({"params": _numpy_tree(new_state.params)})
    n = n_off = 0
    for name, want in want_params.items():
        err = (named[name].detach() - want).abs()
        assert float(err.max()) <= 1e-3, name
        n, n_off = n + err.numel(), n_off + int((err > 1e-5).sum())
    assert n_off <= 1e-3 * n, f"{n_off} of {n} updated parameters off by more than 1e-5"


def test_eval_step_uses_running_stats():
    """The eval step runs the folded eval graph and leaves the running
    statistics alone; the train step moves them."""
    cfg = ModelConfig(network_mode="ultralite", **TINY)
    tcfg = TrainConfig()
    model = MVSNet(cfg, seed=2)
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    batch = _train_batch()
    before = {k: b.clone() for k, b in model.named_buffers()}
    metrics = train_lib.make_eval_step(model, cfg, tcfg)(state, batch)
    assert np.isfinite(metrics["loss"].item()) and 0.0 <= metrics["less_one"].item() <= 1.0
    assert all(torch.equal(before[k], b) for k, b in model.named_buffers())
    train_lib.make_train_step(model, cfg, tcfg)(state, batch)
    assert not all(torch.equal(before[k], b) for k, b in model.named_buffers())


@pytest.mark.parametrize("kw", [dict(refinement=True),
                                dict(regularization="GRU", refinement=True)])
def test_unported_training_graphs_raise(kw):
    """Refinement, on either regularizer, waits for its slice (the GRU
    graph trains: tests/test_torch_gru.py)."""
    cfg = ModelConfig(network_mode="ultralite", **TINY, **kw)
    model = MVSNet(dataclasses.replace(cfg, refinement=False))
    with pytest.raises(NotImplementedError):
        state = train_lib.create_train_state(model, cfg, TrainConfig(), device="cpu")
        train_lib.make_train_step(model, cfg, TrainConfig())(state, _train_batch())
