"""The port's multi-device paths (`mvsnet_tpu_torch/parallel/`) on CPU ranks
against the unsharded port and the JAX package's sharded functions.

Ranks are separate processes over gloo (`parallel.launch.spawn`); their
programs live in `mvsnet_tpu_torch/parallel/rank_checks.py`, so the
children import the port alone. The JAX side runs in this process on the
8-device CPU mesh of tests/conftest.py. Two worlds, of 4 and of 2 ranks,
start once for the module, in background threads, while the JAX side
computes. The sliced cost kernel K1s has its own file,
tests/test_torch_sweep_sharded.py. The GRU's serving on two ranks (padded
batches) is held against the port's single device and JAX's
`make_sharded_gru_forward` on two devices, with JAX's variables; its train
step on two ranks against the port's single device, whose JAX parity is
tests/test_torch_gru.py's.

Tolerances: the sharded port against the unsharded port 1e-5 (float32
sums in other blocks: halo planes, slab convs); a single halo op 1e-6; the
forward against JAX those of tests/test_torch_models.py (depth 2e-3, prob
5e-3); the train step those of tests/test_torch_train.py (loss 1e-4
relative, each gradient leaf 1e-3 of its largest entry, running
statistics 1e-4), and the running statistics equal on every rank.
"""

import concurrent.futures
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import tiny_inputs  # noqa: E402

from mvsnet_tpu import train_lib as jax_train  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.parallel import factorize_devices as jax_factorize  # noqa: E402
from mvsnet_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mvsnet_tpu.parallel import set_active_mesh  # noqa: E402
from mvsnet_tpu.parallel.infer_step import make_sharded_forward as jax_sharded_forward  # noqa: E402
from mvsnet_tpu.parallel.infer_step import (  # noqa: E402
    make_sharded_gru_forward as jax_sharded_gru_forward)
from mvsnet_tpu.parallel.train_step import make_sharded_train_step as jax_sharded_step  # noqa: E402
from mvsnet_tpu.parallel.train_step import shard_state  # noqa: E402
from mvsnet_tpu_torch import train_lib  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.entry import dryrun_multichip  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.parallel import factorize_devices, rank_checks  # noqa: E402
from mvsnet_tpu_torch.parallel.infer_step import make_sharded_gru_forward  # noqa: E402
from mvsnet_tpu_torch.parallel.launch import spawn  # noqa: E402
from mvsnet_tpu_torch.parallel.mesh import axis_ranks, make_mesh, rank_coords  # noqa: E402
from mvsnet_tpu_torch.predict import Predictor  # noqa: E402

SERVE = dict(view_num=3, max_d=32, width=64, height=64, network_mode="lite",
             compute_dtype="float32")
TRAIN = dict(view_num=3, max_d=8, width=64, height=64, network_mode="ultralite",
             compute_dtype="float32")
TCFG = dict(loss_type="power", alpha=0.25, beta=1.0, grad_loss=True)
PORT = dict(rtol=1e-5, atol=1e-5)
GRU = dict(view_num=3, max_d=8, width=64, height=64, regularization="GRU",
           compute_dtype="float32")


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


def _scene(B, D, seed=3):
    """B maps of three views with a baseline, 64x64, D planes from 5.0 by
    0.5; each map its own images and a slightly moved second view. Returns
    `Predictor.predict`'s arrays: images, cams, depth start, interval, end."""
    _, cams, _, _ = tiny_inputs(D=D)
    cams = np.repeat(np.array(cams, np.float32), B, axis=0)
    cams[:, 1, 0, 0, 3] += 0.4 + 0.05 * np.arange(B)
    cams[:, 2, 0, 1, 3] -= 0.3
    images = np.random.default_rng(seed).standard_normal((B, 3, 64, 64, 3)).astype(np.float32)
    return (images, cams, cams[:, 0, 1, 3, 0].copy(), cams[:, 0, 1, 3, 1].copy(),
            cams[:, 0, 1, 3, 3].copy())


def _train_batch(B=2):
    images, cams = _scene(B, 8, seed=5)[:2]
    rng = np.random.default_rng(6)
    gt = rng.uniform(5.0, 8.5, (B, 16, 16, 1)).astype(np.float32)
    gt[:, :3] = 0.0
    gt[1, :, :2] = 0.0
    return images, cams, gt, gt


def _halo_inputs(shape):
    rng = np.random.default_rng(8)
    return {"shape": shape,
            "x": rng.standard_normal((1, 16, 6, 10, 8)).astype(np.float32),
            "k": (rng.standard_normal((3, 3, 3, 8, 8)) / 15).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "x_deconv": rng.standard_normal((1, 8, 3, 5, 8)).astype(np.float32),
            "k_deconv": (rng.standard_normal((3, 3, 3, 8, 8)) / 15).astype(np.float32)}


class World:
    """The module's JAX weights and inputs, and the two rank worlds'
    results (futures until first read)."""

    def __init__(self, pool):
        serve_cfg = JaxModelConfig(**SERVE)
        images, cams, ds, di, _ = _scene(1, 32)
        self.serve_model = JaxMVSNet(serve_cfg)
        init = jax.jit(lambda key: self.serve_model.init(
            key, images, cams, ds, di, method=JaxMVSNet.forward_3dcnn))
        self.serve_vars = _perturb(_numpy_tree(init(jax.random.PRNGKey(7))), 11)
        sd = {k: v.numpy() for k, v in state_dict_from_jax(self.serve_vars).items()}

        train_cfg = JaxModelConfig(**TRAIN)
        self.batch = _train_batch()
        self.train_model = JaxMVSNet(train_cfg)
        tb = self.batch
        tinit = jax.jit(lambda key: self.train_model.init(
            key, tb[0], tb[1], tb[1][:, 0, 1, 3, 0], tb[1][:, 0, 1, 3, 1], training=True))
        self.train_vars = _perturb(_numpy_tree(tinit(jax.random.PRNGKey(7))), 12)
        tsd = {k: v.numpy() for k, v in state_dict_from_jax(self.train_vars).items()}

        # the GRU's: JAX's serving variables ("lite"), seeded port weights
        # for the train step (JAX parity is tests/test_torch_gru.py's)
        self.gru_cfg = JaxModelConfig(network_mode="lite", **GRU)
        self.gru_model = JaxMVSNet(self.gru_cfg)
        self.gru_serve = {1: _scene(1, 8, seed=7), 3: _scene(3, 8, seed=8)}
        g_images, g_cams, g_ds, _, g_de = self.gru_serve[1]
        ginit = jax.jit(lambda key: self.gru_model.init(
            key, g_images, g_cams, g_ds, depth_interval=None, depth_end=g_de,
            method=JaxMVSNet.forward_gru_wta))
        self.gru_vars = _perturb(_numpy_tree(ginit(jax.random.PRNGKey(7))), 13)
        self.gru_sd = {k: v.numpy() for k, v in state_dict_from_jax(self.gru_vars).items()}
        self.gru_train_sd = {k: v.numpy() for k, v in MVSNet(
            ModelConfig(network_mode="ultralite", **GRU), seed=6).state_dict().items()}

        self.latency = {shape: _scene(1, 32) for shape in ((1, 4, 1), (1, 2, 2))}
        self.fallback = _scene(1, 16)
        self.throughput = _scene(4, 32, seed=4)

        def predict(shape, inputs, cfg=SERVE):
            return ("predict", {"shape": shape, "cfg": cfg, "state_dict": sd,
                                "inputs": inputs})

        def train(shape):
            return ("train", {"shape": shape, "cfg": TRAIN, "tcfg": TCFG,
                              "state_dict": tsd, "batch": self.batch})
        cases4 = [("halo", _halo_inputs((1, 4, 1))),
                  ("halo", _halo_inputs((1, 2, 2))),
                  predict((1, 4, 1), self.latency[(1, 4, 1)]),
                  predict((1, 2, 2), self.latency[(1, 2, 2)]),
                  predict((1, 4, 1), self.fallback, dict(SERVE, max_d=16)),
                  predict(None, self.throughput),
                  train((2, 2, 1)),
                  ("default_device_error", None)]
        gru_predict = [("predict", {"shape": None, "cfg": dict(GRU, network_mode="lite"),
                                    "state_dict": self.gru_sd, "inputs": self.gru_serve[B]})
                       for B in (1, 3)]
        gru_train = ("train", {"shape": (2, 1, 1), "cfg": dict(GRU, network_mode="ultralite"),
                               "tcfg": {}, "state_dict": self.gru_train_sd,
                               "batch": self.batch})
        cases2 = [predict(None, self.throughput), train((2, 1, 1)), *gru_predict, gru_train]
        self.index4 = {"halo4": 0, "halo2": 1, "latency141": 2, "latency122": 3,
                       "fallback": 4, "throughput": 5, "train": 6, "default_device_error": 7}
        self.index2 = {"throughput": 0, "train": 1, "gru1": 2, "gru3": 3, "gru_train": 4}
        self.state_dict = sd
        self._futures = {
            4: pool.submit(spawn, rank_checks.run, 4, "gloo", cases4),
            2: pool.submit(spawn, rank_checks.run, 2, "gloo", cases2)}

    def ranks(self, world, case):
        """[rank 0's result, rank 1's, ...] of one case."""
        index = (self.index4 if world == 4 else self.index2)[case]
        return [r[index] for r in self._futures[world].result()]


@pytest.fixture(scope="module")
def world():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        try:
            yield World(pool)
        finally:
            set_active_mesh(None)


@pytest.mark.parametrize("n", range(1, 17))
def test_factorize_devices_matches_jax(n):
    assert factorize_devices(n) == jax_factorize(n)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2)])
def test_rank_coords_match_jax_mesh_order(shape):
    """Rank r sits where JAX's mesh puts device r, and each axis group
    lists its ranks in that axis's order."""
    devices = np.vectorize(lambda d: d.id)(jax_make_mesh(int(np.prod(shape)), shape).devices)
    for r in range(devices.size):
        assert devices[rank_coords(r, shape)] == r
    for axis in range(3):
        for ranks in axis_ranks(shape, axis):
            assert [rank_coords(r, shape)[axis] for r in ranks] == list(range(shape[axis]))


def test_size_one_mesh_needs_no_process_group():
    mesh = make_mesh(backend="gloo")
    assert (mesh.shape, mesh.coords, mesh.device.type, mesh.groups) == \
        ((1, 1, 1), (0, 0, 0), "cpu", {})
    x = torch.arange(6.0)
    assert mesh.all_gather(x, "depth") is x and mesh.all_reduce(x, None) is x


@pytest.mark.parametrize("depth", [4, 2])
@pytest.mark.parametrize("op", ["s1", "s2", "deconv"])
def test_halo_ops_match_unsharded(world, depth, op):
    ranks = world.ranks(4, f"halo{depth}")
    got = np.concatenate([r[op] for r in sorted(ranks, key=lambda r: r["coords"])
                          if r["coords"][2] == 0], axis=1)
    np.testing.assert_allclose(got, ranks[0]["want_" + op], rtol=1e-6, atol=1e-6)


def _port_single(inputs, cfg=SERVE, state_dict=None):
    p = Predictor(ModelConfig(**cfg), state_dict={k: torch.from_numpy(v) for k, v in
                                                  state_dict.items()}, device="cpu")
    return p.predict(*inputs)


def _jax_forward(world, inputs, shape=None):
    images, cams, ds, di = (jnp.asarray(a) for a in inputs[:4])
    if shape is None:
        return world.serve_model.apply(world.serve_vars, images, cams, ds, di,
                                       method=JaxMVSNet.forward_3dcnn)
    mesh = jax_make_mesh(int(np.prod(shape)), shape)
    try:
        return jax_sharded_forward(world.serve_model, JaxModelConfig(**SERVE), mesh)(
            world.serve_vars, images, cams, ds, di)[:2]
    finally:
        set_active_mesh(None)


def _assert_jax(got, want):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 2, 2)])
def test_latency_regime_matches_port_and_jax(world, shape):
    inputs = world.latency[shape]
    ranks = world.ranks(4, f"latency{''.join(map(str, shape))}")
    single = _port_single(inputs, state_dict=world.state_dict)
    for r in ranks:                      # every rank holds the whole result
        assert r["mesh"] == shape and not r["residual"].any()
        np.testing.assert_allclose(r["depth"], single[0], **PORT)
        np.testing.assert_allclose(r["prob"], single[1], **PORT)
        assert not any("gathering the volume" in m for m in r["log"])
    _assert_jax((ranks[0]["depth"], ranks[0]["prob"]), _jax_forward(world, inputs, shape))
    _assert_jax((ranks[0]["depth"], ranks[0]["prob"]), _jax_forward(world, inputs))


def test_uneven_depth_slabs_fall_back_to_the_whole_unet(world):
    """max_d=16 on 4 depth ranks: slabs of 4 planes cannot halve three
    times, so the U-Net runs whole on every rank, and the log says so."""
    ranks = world.ranks(4, "fallback")
    single = _port_single(world.fallback, dict(SERVE, max_d=16), world.state_dict)
    for r in ranks:
        assert any("gathering the volume" in m for m in r["log"]), r["log"]
        np.testing.assert_allclose(r["depth"], single[0], **PORT)
        np.testing.assert_allclose(r["prob"], single[1], **PORT)


@pytest.mark.parametrize("n", [2, 4])
def test_throughput_regime_matches_port_and_jax(world, n):
    """B=4 over the default serving mesh of n ranks, (1, n, 1)."""
    ranks = world.ranks(n, "throughput")
    single = _port_single(world.throughput, state_dict=world.state_dict)
    for r in ranks:
        assert r["mesh"] == (1, n, 1)
        np.testing.assert_allclose(r["depth"], single[0], **PORT)
        np.testing.assert_allclose(r["prob"], single[1], **PORT)
    _assert_jax((ranks[0]["depth"], ranks[0]["prob"]),
                _jax_forward(world, world.throughput, (1, n, 1)))


@pytest.fixture(scope="module")
def jax_single_step(world):
    """JAX's single-device step on the training batch."""
    return _jax_step(world, None)


def _jax_step(world, shape):
    cfg, tcfg = JaxModelConfig(**TRAIN), JaxTrainConfig(**TCFG)
    model, v = world.train_model, world.train_vars
    state = jax_train.TrainState.create(apply_fn=model.apply, params=v["params"],
                                        batch_stats=v["batch_stats"],
                                        tx=jax_train.make_optimizer(tcfg))
    if shape is None:
        def loss_fn(p):
            return jax_train.compute_loss(model, cfg, tcfg, p, state.batch_stats,
                                          world.batch, True)
        grads, (stats, metrics) = jax.jit(jax.grad(loss_fn, has_aux=True))(state.params)
        return _numpy_tree(grads), _numpy_tree(stats), metrics
    # the sharded step: gradients and statistics from the updated state
    mesh = jax_make_mesh(int(np.prod(shape)), shape)
    try:
        step, mesh = jax_sharded_step(model, cfg, tcfg, mesh=mesh, donate=False)
        new_state, metrics = step(shard_state(state, mesh), world.batch)
    finally:
        set_active_mesh(None)
    return None, _numpy_tree(new_state.batch_stats), metrics


def _assert_grads(got, want_tree):
    want = state_dict_from_jax({"params": want_tree})
    assert set(want) == set(got)
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        err = float(np.abs(got[name] - w.numpy()).max())
        assert err <= 1e-3 * scale, f"{name}: max err {err:.3e}, max |grad| {scale:.3e}"


def _assert_stats(got, want_tree):
    for name, w in state_dict_from_jax({"batch_stats": want_tree}).items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1)])
def test_sharded_train_step_matches_jax(world, jax_single_step, shape):
    """Summed gradients, the batch-wide sums of the power + gradient loss
    (beta 1) and global batch-norm statistics: the sharded step is the
    single-device step, as in JAX."""
    ranks = world.ranks(int(np.prod(shape)), "train")
    grads, stats, metrics = jax_single_step
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["loss"], float(metrics["loss"]), rtol=1e-4)
        for k in ("less_one", "less_three"):
            np.testing.assert_allclose(r["metrics"][k], float(metrics[k]), atol=1e-6)
        _assert_grads(r["grads"], grads)
        _assert_stats(r["buffers"], stats)
        for name, b in r["buffers"].items():     # the same statistics on every rank
            np.testing.assert_array_equal(b, ranks[0]["buffers"][name], err_msg=name)
        for name, p in r["params"].items():
            np.testing.assert_array_equal(p, ranks[0]["params"][name], err_msg=name)
    _, sharded_stats, sharded_metrics = _jax_step(world, shape)
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(sharded_metrics["loss"]),
                               rtol=1e-4)
    _assert_stats(ranks[0]["buffers"], sharded_stats)


def test_sharded_train_step_matches_port_single(world):
    """The 2-rank step against the port's own single-device step."""
    model = MVSNet(ModelConfig(**TRAIN))
    model.load_state_dict(state_dict_from_jax(world.train_vars))
    state = train_lib.create_train_state(model, ModelConfig(**TRAIN), TrainConfig(**TCFG),
                                         device="cpu")
    _, metrics = train_lib.make_train_step(model, ModelConfig(**TRAIN),
                                           TrainConfig(**TCFG))(state, world.batch)
    r = world.ranks(2, "train")[0]
    np.testing.assert_allclose(r["metrics"]["loss"], metrics["loss"].item(), rtol=1e-5)
    for name, p in model.named_parameters():
        scale = max(float(p.grad.abs().max()), 1e-12)
        assert float(np.abs(r["grads"][name] - p.grad.numpy()).max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_train_step_leaves_no_mesh_state(world, n):
    """The batch norms sum over 'data' only inside the step: afterwards the
    model trains or serves alone."""
    assert not any(r["norms_synced_after"] for r in world.ranks(n, "train"))


def test_predictor_default_device_raises_without_cuda(world):
    """Inside a process group, device=None is the rank's card."""
    for message in world.ranks(4, "default_device_error"):
        assert message is not None and "CUDA" in message


def test_sharded_gru_forward_waits_for_the_gru_slice():
    """On a mesh of one rank the sharded GRU forward is the model's own
    `forward_gru_wta`, bit for bit (the ranks' cases:
    `test_sharded_gru_forward_matches_single`). The name dates from before
    the GRU slice, when this forward raised."""
    cfg = ModelConfig(**dict(SERVE, max_d=8, regularization="GRU", network_mode="ultralite"))
    model = MVSNet(cfg, seed=2)
    images, cams, ds, _, de = (torch.from_numpy(a) for a in _scene(2, 8))
    with torch.no_grad():
        got = make_sharded_gru_forward(model, make_mesh(backend="gloo"))(images, cams, ds, de)
        want = model.forward_gru_wta(images, cams, ds, None, de)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B", [1, 3])
def test_sharded_gru_forward_matches_single(world, B):
    """GRU serving on two gloo ranks (the default mesh of the process
    group): B = 1 and B = 3 pad to 2 and 4 maps, each rank runs its half,
    and every rank holds the single-device forward's B maps; rank 0's are
    JAX's `make_sharded_gru_forward`'s on two devices, which pads the same
    way, with the same variables."""
    inputs = world.gru_serve[B]
    ranks = world.ranks(2, f"gru{B}")
    single = _port_single(inputs, dict(GRU, network_mode="lite"), world.gru_sd)
    for r in ranks:
        assert r["mesh"] == (1, 2, 1) and r["depth"].shape == (B, 16, 16, 1)
        assert not r["residual"].any()
        np.testing.assert_allclose(r["depth"], single[0], **PORT)
        np.testing.assert_allclose(r["prob"], single[1], **PORT)
    images, cams, ds, _, de = (jnp.asarray(a) for a in inputs)
    mesh = jax_make_mesh(2, (1, 2, 1))
    try:
        want = jax_sharded_gru_forward(world.gru_model, world.gru_cfg, mesh)(
            world.gru_vars, images, cams, ds, de)
    finally:
        set_active_mesh(None)
    assert want[0].shape == (B, 16, 16, 1)
    _assert_jax((ranks[0]["depth"], ranks[0]["prob"]), want)


def test_sharded_gru_train_step_matches_single(world):
    """A GRU train step (classification loss) on two data ranks against the
    port's single-device step: the loss to 1e-5, each gradient leaf to 1e-4
    of its largest entry; leaves whose gradient vanishes analytically (a
    bias before a one-channel layer norm, prob_conv's bias before the
    softmax: rounding noise on both sides) stay under 1e-6 of the largest."""
    cfg, tcfg = ModelConfig(network_mode="ultralite", **GRU), TrainConfig()
    model = MVSNet(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in world.gru_train_sd.items()})
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    _, metrics = train_lib.make_train_step(model, cfg, tcfg)(state, world.batch)
    top = max(float(p.grad.abs().max()) for p in model.parameters())
    for r in world.ranks(2, "gru_train"):
        np.testing.assert_allclose(r["metrics"]["loss"], metrics["loss"].item(), rtol=1e-5)
        for k in ("less_one", "less_three"):
            np.testing.assert_allclose(r["metrics"][k], metrics[k].item(), atol=1e-6)
        for name, p in model.named_parameters():
            scale = float(p.grad.abs().max())
            got = r["grads"][name]
            if max(scale, float(np.abs(got).max())) <= 1e-6 * top:
                continue
            assert float(np.abs(got - p.grad.numpy()).max()) <= 1e-4 * scale, name


def test_dryrun_multichip_gloo():
    summary = dryrun_multichip(4, "gloo")
    assert summary["mesh"] == (2, 2, 1) and np.isfinite(summary["loss"])
    assert summary["gru_wta"] == 3
