"""The port's R-MVSNet ConvGRU path on the CPU against the JAX package, on
the same numpy inputs and the JAX model's own variables carried over by
`convert.state_dict_from_jax`: the flexible group norm, the GRU cell and
regularizer, the winner-take-all update, the depth sweep, the softmax
volume, the winner-take-all forward (against JAX and the golden fixture's
`GRU_*` entries), `Predictor`, the classification loss and one train step.
64x64, D=8, V=3, float32 unless a test says otherwise; JAX runs as its own
tests run it on the CPU.

Tolerances: elementwise float32 work (norms, the WTA update, the losses)
1e-5 absolute and relative; a cell or one regularizer step, float32 convs
with sums in another order, 1e-5; a bfloat16 norm within two bfloat16
roundings (2^-7 relative); a bfloat16 cell's float32 state h' = u h +
(1 - u) y within 3 * 2^-8: a gate u or output y that rounds the other way
in bfloat16 moves h' by 2^-8 |h - y| <= 2^-7 or by (1 - u) 2^-8; the sweep's regs and the
softmax volume after the tower, the cost volume and 8 depth steps 1e-4;
depth and prob the golden fixture's (2e-3, 5e-3, tests/test_golden.py); a
train step as tests/test_torch_train.py holds the 3D-CNN's (loss 1e-4
relative, each gradient leaf 1e-3 of its largest entry), but for three
leaves whose gradient vanishes analytically (`VANISHING`).
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

from mvsnet_tpu import losses as jax_losses  # noqa: E402
from mvsnet_tpu import train_lib as jax_train  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.models.gru import ConvGRUCell as JaxConvGRUCell  # noqa: E402
from mvsnet_tpu.models.gru import GRURegularizer as JaxGRURegularizer  # noqa: E402
from mvsnet_tpu.models.layers import GroupNormFlexible as JaxGroupNormFlexible  # noqa: E402
from mvsnet_tpu.ops.depth import winner_take_all_update as jax_wta  # noqa: E402
from mvsnet_tpu.predict import Predictor as JaxPredictor  # noqa: E402
from mvsnet_tpu_torch import losses, train_lib  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.models.gru import ConvGRUCell, GRURegularizer, gru_filter_sizes  # noqa: E402
from mvsnet_tpu_torch.models.layers import GroupNormFlexible  # noqa: E402
from mvsnet_tpu_torch.models.mvsnet import GRUSweep  # noqa: E402
from mvsnet_tpu_torch.ops.depth import winner_take_all_update  # noqa: E402
from mvsnet_tpu_torch.predict import Predictor  # noqa: E402

TINY = dict(view_num=3, max_d=8, width=64, height=64, regularization="GRU",
            compute_dtype="float32")
ELEM = dict(atol=1e-5, rtol=1e-5)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _perturb(variables, seed):
    """Non-identity norms: random scale in [0.5, 1.5), bias ~ 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        if name == "bias" and "norm" in str(getattr(path[-2], "key", "")):
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return {c: jax.tree_util.tree_map_with_path(f, t) for c, t in variables.items()}


def _scene(D=8):
    """Three views with a baseline: images, cams, depth start, interval, end."""
    images, cams, ds, di = tiny_inputs(D=D)
    cams = np.array(cams, np.float32)
    cams[0, 1, 0, 0, 3] += 0.4
    cams[0, 2, 0, 1, 3] -= 0.3
    return (np.array(images), cams, np.array(ds), np.array(di),
            cams[:, 0, 1, 3, 3].copy())


def _jax_apply(model, method, v, *args, **kw):
    return jax.jit(lambda v, *a: model.apply(v, *a, method=method, **kw))(v, *args)


class Graph:
    """A JAX GRU model of one network mode: its variables (init jitted,
    PRNGKey(7); `perturbed` with non-identity norms) and jitted methods."""

    def __init__(self, mode, **kw):
        self.cfg = JaxModelConfig(network_mode=mode, **TINY, **kw)
        self.model = JaxMVSNet(self.cfg)
        images, cams, ds, di = tiny_inputs()
        init = jax.jit(lambda key: self.model.init(
            key, images, cams, ds, di, method=JaxMVSNet.forward_prob_recurrent))
        self.golden = _np(init(jax.random.PRNGKey(7)))
        self.perturbed = _perturb(self.golden, 11)

    def apply(self, method, v, *args, **kw):
        return _jax_apply(self.model, method, v, *args, **kw)

    def port(self, variables, **kw):
        model = MVSNet(ModelConfig(network_mode=self.cfg.network_mode, **TINY, **kw))
        model.load_state_dict(state_dict_from_jax(variables))
        return model


@pytest.fixture(scope="module")
def lite():
    return Graph("lite")


@pytest.fixture(scope="module")
def normal():
    return Graph("normal")


def _graph(request, mode):
    return request.getfixturevalue(mode)


@pytest.fixture
def no_eager(monkeypatch):
    """Fails the test if its sweep runs `GRUSweep.eager`: under autograd the
    sweep must recompute its depth steps (`GRUSweep.remat`)."""
    def eager(*args, **kwargs):
        raise AssertionError("the sweep ran eagerly under autograd")
    monkeypatch.setattr(GRUSweep, "eager", eager)


# ---------------------------------------------------------------- norms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch,C,kw", [
    ("layer", 16, dict(group_channel=16)),                      # G = 1
    ("instance", 8, dict(channel_wise=False, group=32)),        # G = min(32, 8) >= C
    ("group", 32, dict(group_channel=16)),                      # G = 2
])
def test_group_norm_flexible_matches_jax(branch, C, kw, dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 6, 10, C)) * 3 + 1).astype(np.float32)
    scale = (0.5 + rng.random(C)).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    want = JaxGroupNormFlexible(**kw).apply({"params": {"scale": scale, "bias": bias}},
                                            jnp.asarray(x, dtype))
    norm = GroupNormFlexible(C, **kw)
    assert norm.groups == {"layer": 1, "instance": C, "group": 2}[branch]
    norm.load_state_dict({"scale": _t(scale), "bias": _t(bias)})
    with torch.no_grad():
        got = norm(_t(x).to(DTYPES[dtype]))
    assert got.dtype == DTYPES[dtype]
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **ELEM)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


# ---------------------------------------------------------------- cells


def _gru_params(v):
    return v["params"]["gru_sweep"]["gru"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lite", "normal"])
def test_conv_gru_cell_matches_jax(request, mode, dtype):
    """The first cell, one step, from a nonzero float32 state; x in the
    compute dtype, as the negated cost slice arrives."""
    g = _graph(request, mode)
    f = gru_filter_sizes(mode)[0]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 16, 16, 32 if mode == "normal" else 16)).astype(np.float32)
    h = np.tanh(rng.standard_normal((1, 16, 16, f))).astype(np.float32)
    params = _gru_params(g.perturbed)["conv_gru1"]
    jd = None if dtype == "float32" else "bfloat16"
    want, _ = JaxConvGRUCell(f, dtype=jd).apply({"params": params},
                                                jnp.asarray(x, dtype), jnp.asarray(h))
    cell = ConvGRUCell(x.shape[-1], f, dtype=DTYPES[dtype])
    cell.load_state_dict(state_dict_from_jax({"params": params}))
    with torch.no_grad():
        got = cell(_t(x).to(DTYPES[dtype]), _t(h))
    assert got.dtype == torch.float32                   # the state stays float32
    tol = ELEM if dtype == "float32" else dict(rtol=0, atol=3 * 2 ** -8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("mode", ["lite", "normal"])
def test_gru_regularizer_step_matches_jax(request, mode):
    g = _graph(request, mode)
    f1, f2, f3 = gru_filter_sizes(mode)
    C = 32 if mode == "normal" else 16
    rng = np.random.default_rng(5)
    neg_cost = -rng.random((1, 16, 16, C)).astype(np.float32)
    states = [np.tanh(rng.standard_normal((1, 16, 16, f))).astype(np.float32)
              for f in (f1, f2, f3)]
    params = _gru_params(g.perturbed)
    reg_w, states_w = JaxGRURegularizer(mode, dtype="float32").apply(
        {"params": params}, jnp.asarray(neg_cost), [jnp.asarray(s) for s in states])
    reg_mod = GRURegularizer(C, mode, dtype=torch.float32)
    reg_mod.load_state_dict(state_dict_from_jax({"params": params}))
    with torch.no_grad():
        reg, new = reg_mod(_t(neg_cost), [_t(s) for s in states])
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_w), **ELEM)
    for a, b in zip(new, states_w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ELEM)
    zeros = GRURegularizer.init_states(2, 4, 6, mode)
    assert [tuple(z.shape) for z in zeros] == [(2, 4, 6, f) for f in (f1, f2, f3)]
    assert all(z.dtype == torch.float32 and not z.any() for z in zeros)


@pytest.mark.parametrize("mode", ["lite", "normal"])
def test_gru_weights_load_strictly(request, mode):
    """`load_state_dict(strict=True)` takes JAX's GRU variables: the same
    names (gru_sweep.gru.conv_gruK.*, gru_sweep.gru.prob_conv.*) and
    shapes, and no batch statistics."""
    g = _graph(request, mode)
    sd = state_dict_from_jax(g.golden)
    model = MVSNet(ModelConfig(network_mode=mode, **TINY))
    assert set(sd) == set(model.state_dict())
    assert "gru_sweep.gru.conv_gru1.gates_conv.kernel" in sd
    assert "gru_sweep.gru.prob_conv.bias" in sd
    assert not list(model.buffers())
    model.load_state_dict(sd, strict=True)


# ---------------------------------------------------------------- WTA


def test_winner_take_all_update_matches_jax():
    """Eight planes scanned from zeros, with exact ties: planes equal to the
    running maximum (the first keeps the pixel), probabilities of zero, and
    a per-map depth; equal to JAX's bit for bit."""
    rng = np.random.default_rng(6)
    B, D = 2, 8
    probs = rng.random((D, B, 5, 7, 1)).astype(np.float32)
    probs[3] = probs[1]                        # a later plane ties an earlier one
    probs[5, :, :2] = probs[:5, :, :2].max(axis=0)   # ties the running maximum
    probs[0, 0, 0] = 0.0                       # zero probability: no update
    depths = (np.array([5.0, 7.0], np.float32)[None] +
              np.arange(D, dtype=np.float32)[:, None] * 0.5)
    carry_j = tuple(jnp.zeros((B, 5, 7, 1)) for _ in range(3))
    carry_t = tuple(torch.zeros((B, 5, 7, 1)) for _ in range(3))
    for d in range(D):
        carry_j = jax_wta(carry_j, jnp.asarray(probs[d]), jnp.asarray(depths[d]))
        carry_t = winner_take_all_update(carry_t, _t(probs[d]), _t(depths[d]))
    for a, b in zip(carry_t, carry_j):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the tie at plane 5 left those pixels to the earlier plane
    first = np.argmax(probs[:, :, :2], axis=0)
    np.testing.assert_array_equal(carry_t[1].numpy()[:, :2],
                                  np.take_along_axis(depths[:, :, None, None, None],
                                                     first[None], 0)[0])


# ---------------------------------------------------------------- sweep and graphs


def _jax_sweep_inputs(scene):
    images, cams, ds, di, de = scene
    return jnp.asarray(images), jnp.asarray(cams), jnp.asarray(ds), jnp.asarray(di)


def test_graph_cache_keeps_one_capture_per_shape_and_weights(monkeypatch):
    """`GRUSweep.graphed` keeps one capture per shape, at most `MAX_GRAPHS`,
    the least recently used going first, and drops them all when the
    parameters move (a load with `assign`). A capture needs a card
    (tests/test_torch_cuda.py); here a stand-in records the captures."""
    from mvsnet_tpu_torch.models import mvsnet as port_mvsnet

    captures = []

    class Capture:
        def __init__(self, sweep, cost, wta):
            captures.append(cost.shape[2])

        def run(self, cost, samples):
            return None, None

    monkeypatch.setattr(port_mvsnet, "_StepGraph", Capture)
    model = MVSNet(ModelConfig(network_mode="ultralite", **TINY))
    sweep = model.gru_sweep

    def run(h):
        sweep.graphed(torch.zeros((1, 8, h, 16, 8)))

    run(8)
    run(8)
    assert captures == [8] and len(sweep._graphs) == 1
    for h in (16, 24, 32, 40):
        run(h)
    assert captures == [8, 16, 24, 32, 40] and len(sweep._graphs) == sweep.MAX_GRAPHS == 4
    run(16)                     # kept, and now the most recently used
    run(8)                      # was dropped for 40; 24 goes now
    assert captures == [8, 16, 24, 32, 40, 8]
    assert [k[1] for k in sweep._graphs] == [32, 40, 16, 8]
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    run(8)
    assert captures[-1] == 8 and len(captures) == 7 and len(sweep._graphs) == 1


def test_gru_sweep_regs_match_jax(lite):
    scene = _scene()
    images, cams, ds, di = _jax_sweep_inputs(scene)
    want = lite.apply(JaxMVSNet.gru_cost_sweep, lite.perturbed, images, cams, ds, di)
    model = lite.port(lite.perturbed)
    with torch.no_grad():
        dsr, dir_, der = model.depth_range(_t(scene[2]), _t(scene[3]), 1, torch.device("cpu"))
        regs, carry = model.gru_cost_sweep(_t(scene[0]), _t(scene[1]), dsr, dir_, der)
    assert carry is None and regs.shape == (1, 8, 16, 16) and regs.dtype == torch.float32
    np.testing.assert_allclose(regs.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_forward_prob_recurrent_matches_jax(lite, no_eager):
    """With autograd recording, as in training: the recomputing sweep."""
    scene = _scene()
    want = lite.apply(JaxMVSNet.forward_prob_recurrent, lite.perturbed,
                      *_jax_sweep_inputs(scene))
    model = lite.port(lite.perturbed)
    got = model.forward_prob_recurrent(*(_t(a) for a in scene[:4]))
    assert got.requires_grad
    got = got.detach()
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("inverse_depth", [False, True])
def test_forward_gru_wta_matches_jax(lite, inverse_depth):
    """With depth_end (the interval is (end - start) / (D - 1)) and, for the
    inverse-depth samples, planes uniform in 1 / depth."""
    scene = _scene()
    images, cams, ds, _ = _jax_sweep_inputs(scene)
    de = jnp.asarray(scene[4] + 1.5)
    jmodel = JaxMVSNet(JaxModelConfig(network_mode="lite", inverse_depth=inverse_depth, **TINY))
    want = _jax_apply(jmodel, JaxMVSNet.forward_gru_wta, lite.perturbed, images, cams, ds,
                      depth_end=de)
    model = lite.port(lite.perturbed, inverse_depth=inverse_depth)
    with torch.no_grad():
        depth, prob = model.forward_gru_wta(_t(scene[0]), _t(scene[1]), _t(scene[2]),
                                            depth_end=_t(np.asarray(de)))
    assert depth.shape == prob.shape == (1, 16, 16, 1)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want[0]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want[1]), rtol=5e-3, atol=5e-3)


def test_forward_gru_wta_matches_golden(lite):
    """The golden fixture's GRU entries (lite, PRNGKey(7), the depth
    interval path), and the same through `Predictor`'s depth_end path."""
    data = np.load(GOLDEN)
    images, cams, ds, di = (np.array(a) for a in tiny_inputs())
    model = lite.port(lite.golden)
    with torch.no_grad():
        depth, prob = model.forward_gru_wta(_t(images), _t(cams), _t(ds), _t(di))
    np.testing.assert_allclose(depth.numpy(), data["GRU_depth"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob.numpy(), data["GRU_prob"], rtol=5e-3, atol=5e-3)
    p = Predictor(ModelConfig(network_mode="lite", **TINY),
                  state_dict=state_dict_from_jax(lite.golden), device="cpu")
    depth, prob, residual = p.predict(images, cams, ds, di, cams[:, 0, 1, 3, 3])
    np.testing.assert_allclose(depth, data["GRU_depth"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prob, data["GRU_prob"], rtol=5e-3, atol=5e-3)
    assert not residual.any()


def test_predictor_gru_matches_jax_predictor(normal):
    """`Predictor.predict` of a "normal" GRU with JAX's arguments, the
    interval ignored and depth_end read, against JAX's `Predictor`."""
    images, cams, ds, di, de = _scene()
    de = de + 1.0
    jp = JaxPredictor(normal.cfg)
    jp.variables = normal.perturbed
    want = jp.predict(images, cams, ds, di, de)
    p = Predictor(ModelConfig(network_mode="normal", **TINY),
                  state_dict=state_dict_from_jax(normal.perturbed), device="cpu")
    got = p.predict(images, cams, ds, di * 3.0, de)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=5e-3, atol=5e-3)
    assert not got[2].any() and got[2].shape == got[0].shape


# ---------------------------------------------------------------- losses


def _classification_inputs():
    """Two maps of D=8 planes from 5.0 by 0.5: ground truth half-way between
    planes (rounds half to even), below the first plane and beyond the last
    (clipped), invalid pixels, a whole map of them on the second; the
    probabilities with exact ties of the largest."""
    rng = np.random.default_rng(9)
    B, D, H, W = 2, 8, 6, 5
    logits = rng.standard_normal((B, D, H, W)).astype(np.float32)
    logits[:, 5, 0] = logits[:, 2, 0] = 4.0                 # tie: argmax is plane 2
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    gt = (5.0 + rng.uniform(0, 3.5, (B, H, W, 1))).astype(np.float32)
    gt[0, 1, :, 0] = 5.0 + 0.5 * np.array([0.5, 1.5, 2.5, 3.5, 6.5], np.float32)
    gt[0, 2, :2, 0] = [3.0, 12.0]                           # out of range
    gt[0, 3, 1:3, 0] = 0.0                                  # invalid
    gt[1] = 0.0                                             # a map with none valid
    return prob.astype(np.float32), gt, np.array([5.0, 5.0], np.float32), \
        np.array([0.5, 0.5], np.float32)


def test_classification_loss_matches_jax():
    prob, gt, start, interval = _classification_inputs()

    def jfn(p):
        xent, mae, l1, l3, wta = jax_losses.mvsnet_classification_loss(
            p, jnp.asarray(gt), 8, jnp.asarray(start), jnp.asarray(interval))
        return xent, (mae, l1, l3, wta)
    (xent_w, aux_w), grad_w = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(prob))
    p = _t(prob).requires_grad_()
    xent, mae, l1, l3, wta = losses.mvsnet_classification_loss(p, _t(gt), 8, _t(start),
                                                               _t(interval))
    xent.backward()
    np.testing.assert_allclose(xent.item(), float(xent_w), **ELEM)
    for got, want in zip((mae, l1, l3, wta), aux_w):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ELEM)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad_w), **ELEM)
    assert float(wta[0, 0, 0, 0]) == 5.0 + 2 * 0.5           # the first of the tied maxima


def test_non_zero_mean_absolute_diff_matches_jax():
    _, gt, _, interval = _classification_inputs()
    pred = gt + np.random.default_rng(10).standard_normal(gt.shape).astype(np.float32)
    want = jax_losses.non_zero_mean_absolute_diff(jnp.asarray(gt), jnp.asarray(pred),
                                                  jnp.asarray(interval))
    got = losses.non_zero_mean_absolute_diff(_t(gt), _t(pred), _t(interval))
    np.testing.assert_allclose(got.item(), float(want), **ELEM)
    assert losses.non_zero_mean_absolute_diff(_t(gt[1:]), _t(pred[1:]),
                                              _t(interval[1:])).item() == 0.0


# ---------------------------------------------------------------- training


# Gradients that vanish analytically, so that both sides hold rounding
# noise (a few 1e-9 to 1e-8, as large as their difference): a bias in front
# of a layer norm over one channel, which subtracts it (lite's third cell:
# its 2-channel gates split into 1-channel reset and update), and
# prob_conv's bias, a constant over the planes that the softmax removes.
# They are held to 1e-6 of the largest gradient on both sides.
VANISHING = {"gru_sweep.gru.conv_gru3.gates_conv.bias",
             "gru_sweep.gru.conv_gru3.output_conv.bias", "gru_sweep.gru.prob_conv.bias"}


@pytest.fixture(scope="module")
def jax_gru_step(lite):
    """JAX's GRU loss and gradients on a training batch (jitted)."""
    cfg, tcfg = lite.cfg, JaxTrainConfig()
    images, cams = _scene()[:2]
    rng = np.random.default_rng(12)
    gt = rng.uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    gt[0, :3] = 0.0
    batch = (images, cams, gt, gt)
    v = lite.perturbed

    def loss_fn(p):
        return jax_train.compute_loss(lite.model, cfg, tcfg, p, {}, batch, True)
    grads, (_, metrics) = jax.jit(jax.grad(loss_fn, has_aux=True))(v["params"])
    return v, batch, _np(grads), {k: float(x) for k, x in metrics.items()}


def test_gru_train_step_matches_jax(lite, jax_gru_step, no_eager):
    """The port's step runs the recomputing sweep (`no_eager`)."""
    v, batch, grads, metrics = jax_gru_step
    cfg, tcfg = ModelConfig(network_mode="lite", **TINY), TrainConfig()
    model = lite.port(v)
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    state, got = train_lib.make_train_step(model, cfg, tcfg)(state, batch)
    assert state.step == 1 and not list(model.buffers())
    np.testing.assert_allclose(got["loss"].item(), metrics["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["debug"].item(), metrics["debug"], rtol=1e-4)
    for k in ("less_one", "less_three"):
        np.testing.assert_allclose(got[k].item(), metrics[k], atol=1e-6)
    want = state_dict_from_jax({"params": grads})
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    assert any(n.startswith("gru_sweep.") for n in want)
    assert any(n.startswith("feature_net.") for n in want)
    for name, w in want.items():
        g = named[name].grad
        assert g is not None, name
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        if name in VANISHING:
            top = max(float(x.abs().max()) for x in want.values())
            assert max(scale, float(g.abs().max())) <= 1e-6 * top, name
            continue
        assert err <= 1e-3 * scale, f"{name}: max err {err:.3e}, max |grad| {scale:.3e}"


def test_gru_eval_step_runs_the_classification_loss(lite):
    """The eval step (validation rounds) runs the sweep without autograd and
    gives the training forward's metrics on the same weights."""
    images, cams = _scene()[:2]
    gt = np.random.default_rng(13).uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    batch = (images, cams, gt, gt)
    cfg, tcfg = ModelConfig(network_mode="lite", **TINY), TrainConfig()
    model = lite.port(lite.perturbed)
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    got = train_lib.make_eval_step(model, cfg, tcfg)(state, batch)
    _, want = train_lib.compute_loss(model, cfg, tcfg, train_lib.to_device(batch, "cpu"),
                                     training=True)
    for k in ("loss", "less_one", "less_three", "debug"):
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- the recomputing sweep


def _train_sweep(mode, dtype, variables=None):
    """A GRU model's sweep in training mode at `TINY`, with `variables`
    (JAX's) or seeded weights."""
    model = MVSNet(ModelConfig(**dict(TINY, network_mode=mode, compute_dtype=dtype)))
    if variables is not None:
        model.load_state_dict(state_dict_from_jax(variables))
    return model.train().gru_sweep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lite", "normal"])
def test_remat_sweep_equals_eager_sweep(request, mode, dtype):
    """The recomputing sweep (`GRUSweep.remat`, JAX's `nn.remat` over the
    depth step) against the sweep under autograd (`eager`), on one cost
    volume (B=2, D=8, 16x16) and one cotangent of the softmax over depth:
    the regs, the cost volume's gradient and every parameter's gradient
    equal bit for bit, since both sum each gradient in the same order."""
    weights = _graph(request, mode).perturbed
    rng = np.random.default_rng(20)
    C = 32 if mode == "normal" else 16
    cost = rng.random((2, 8, 16, 16, C)).astype(np.float32)
    cotangent = _t(rng.standard_normal((2, 8, 16, 16)))
    runs = []
    for kind in ("remat", "eager"):
        sweep = _train_sweep(mode, dtype, weights)
        c = _t(cost).to(DTYPES[dtype]).requires_grad_()
        regs, carry = getattr(sweep, kind)(c)
        assert carry is None and regs.dtype == torch.float32
        (torch.softmax(regs, dim=1) * cotangent).sum().backward()
        runs.append((regs.detach(), c.grad, dict(sweep.named_parameters())))
    (regs, g_cost, params), (regs_e, g_cost_e, params_e) = runs
    assert torch.equal(regs, regs_e)
    assert g_cost.dtype == DTYPES[dtype] and torch.equal(g_cost, g_cost_e)
    assert len(params) == 32 and set(params) == set(params_e)   # 3 cells x 10, prob_conv 2
    for name, p in params.items():
        assert p.grad is not None and torch.equal(p.grad, params_e[name].grad), name


def _saved_bytes(sweep_fn, cost):
    """Bytes a training forward saves for its backward, each storage once."""
    storages = {}

    def pack(t):
        storage = t.untyped_storage()
        storages[storage.data_ptr()] = storage.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        sweep_fn(cost)
    return sum(storages.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lite", "normal"])
def test_remat_sweep_saves_states_not_activations(mode, dtype):
    """JAX's memory contract for the training sweep: from D=8 to D=16 what
    the recomputing sweep saves grows by at most one plane's float32
    states, its float32 reg and its cost slice a plane (the states and the
    volume, which the saved views share); what the sweep under autograd
    saves grows at least 4x as fast."""
    h = w = 16
    C = 32 if mode == "normal" else 16
    per_plane = h * w * (4 * sum(gru_filter_sizes(mode)) + 4 + C * DTYPES[dtype].itemsize)
    growth = {}
    for kind in ("remat", "eager"):
        sweep = _train_sweep(mode, dtype)
        sizes = []
        for D in (8, 16):
            cost = torch.rand((1, D, h, w, C)).to(DTYPES[dtype]).requires_grad_()
            sizes.append(_saved_bytes(getattr(sweep, kind), cost))
        growth[kind] = (sizes[1] - sizes[0]) / 8
    assert 0 < growth["remat"] <= per_plane, growth
    assert growth["eager"] >= 4 * growth["remat"], growth


def test_gru_sweep_recomputes_whenever_autograd_records(monkeypatch):
    """`GRUSweep.forward` takes the recomputing sweep in training mode (also
    without gradients) and in eval with gradients on and a parameter or the
    volume that needs one, on the CPU the eager sweep in eval otherwise, and
    the two agree."""
    taken = []
    for kind in ("remat", "eager", "graphed"):
        def record(self, *args, _kind=kind, _fn=getattr(GRUSweep, kind), **kwargs):
            taken.append(_kind)
            return _fn(self, *args, **kwargs)
        monkeypatch.setattr(GRUSweep, kind, record)
    sweep = _train_sweep("ultralite", "float32")
    cost = torch.rand((1, 8, 8, 8, 8))
    samples = torch.linspace(5.0, 8.5, 8)[None]
    got = [sweep(cost, samples)]
    with torch.no_grad():
        sweep(cost)
    sweep.eval()
    got.append(sweep(cost, samples))
    with torch.no_grad():
        got.append(sweep(cost, samples))
    sweep.requires_grad_(False)
    sweep(cost)
    sweep(cost.requires_grad_())
    assert taken == ["remat", "remat", "remat", "eager", "eager", "remat"]
    for regs, carry in got[1:]:
        assert torch.equal(regs, got[0][0])
        assert all(torch.equal(a, b) for a, b in zip(carry, got[0][1]))
