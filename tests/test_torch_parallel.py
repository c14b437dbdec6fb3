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

The depth x space blocks (slice 6b): the halo ops on uneven row blocks
(h = 24 splits 12 / 6 / 3 / 2+1 over two 'space' ranks) with their
gradients, the latency regime at height 96 on (1, 1, 2) and (1, 2, 2), an
audit of one rank's tensors (none holds the whole (D, h, w) volume, as
tests/test_parallel.py:78-136 checks JAX's compiled module), the
collective soft-argmin tail, and the blocked train steps on (1, 2, 1),
(1, 2, 2) and (2, 1, 2) at D=16, the refined step on (1, 2, 1) and the
GRU's on (1, 1, 2), against the single device and JAX's sharded step.

Tolerances: the sharded port against the unsharded port 1e-5 (float32
sums in other blocks: halo planes, slab convs); a single halo op 1e-6, its
kernel gradient (summed over the ranks' shares) 1e-5 of its largest entry;
the forward against JAX those of tests/test_torch_models.py (depth 2e-3,
prob 5e-3); the train step those of tests/test_torch_train.py (loss 1e-4
relative, each gradient leaf 1e-3 of its largest entry, running
statistics 1e-4), and the running statistics equal on every rank; the
blocked train step against the port's single step: loss 1e-5, each leaf
1e-4 of its largest entry.
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
from test_torch_refine import seeded_variables  # noqa: E402

from mvsnet_tpu import train_lib as jax_train  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.models.mvsnet import apply_forward_3dcnn as jax_apply_forward_3dcnn  # noqa: E402
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
from mvsnet_tpu_torch.models import feature_net  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402
from mvsnet_tpu_torch.parallel import factorize_devices, rank_checks  # noqa: E402
from mvsnet_tpu_torch.parallel.infer_step import make_sharded_gru_forward  # noqa: E402
from mvsnet_tpu_torch.parallel.launch import spawn  # noqa: E402
from mvsnet_tpu_torch.parallel import halo  # noqa: E402
from mvsnet_tpu_torch.parallel.mesh import AxisSplit, axis_ranks, make_mesh, rank_coords  # noqa: E402
from mvsnet_tpu_torch.predict import Predictor  # noqa: E402

SERVE = dict(view_num=3, max_d=32, width=64, height=64, network_mode="lite",
             compute_dtype="float32")
TRAIN = dict(view_num=3, max_d=8, width=64, height=64, network_mode="ultralite",
             compute_dtype="float32")
TCFG = dict(loss_type="power", alpha=0.25, beta=1.0, grad_loss=True)
PORT = dict(rtol=1e-5, atol=1e-5)
GRU = dict(view_num=3, max_d=8, width=64, height=64, regularization="GRU",
           compute_dtype="float32")
# refinement with the training driver's defaults; D=16 splits over 2 depth ranks
REFINED = dict(SERVE, max_d=16, refinement=True, refinement_network="unet",
               upsample_before_refinement=True, refine_with_confidence=True)
# the blocked train steps: D=16 halves to 1 plane a rank on 2 'depth' ranks
TRAIN16 = dict(TRAIN, max_d=16)
BLOCK_TRAIN = ((1, 2, 1), (1, 2, 2), (2, 1, 2))
# the latency regime at height 96: h = 24 rows, 12 a 'space' rank, whose
# U-Net levels go 6, 3, then 2 and 1
SERVE96 = dict(SERVE, height=96)
REFINED_TCFG = dict(TCFG, refinement_train_mode="all")
# the audit's D differs from every other extent (32 channels, 24 x 16 features)
AUDIT = dict(SERVE96, max_d=64)
# the collective tail's (num_buckets, inverse_depth)
TAILS = ((2, False), (4, False), (4, True))


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


def _scene(B, D, seed=3, H=64):
    """B maps of three views with a baseline, H x 64, D planes from 5.0 by
    0.5; each map its own images and a slightly moved second view. Returns
    `Predictor.predict`'s arrays: images, cams, depth start, interval, end."""
    _, cams, _, _ = tiny_inputs(D=D, H=H)
    cams = np.repeat(np.array(cams, np.float32), B, axis=0)
    cams[:, 1, 0, 0, 3] += 0.4 + 0.05 * np.arange(B)
    cams[:, 2, 0, 1, 3] -= 0.3
    images = np.random.default_rng(seed).standard_normal((B, 3, H, 64, 3)).astype(np.float32)
    return (images, cams, cams[:, 0, 1, 3, 0].copy(), cams[:, 0, 1, 3, 1].copy(),
            cams[:, 0, 1, 3, 3].copy())


def _train_batch(B=2, D=8):
    images, cams = _scene(B, D, seed=5)[:2]
    rng = np.random.default_rng(6)
    gt = rng.uniform(5.0, 8.5, (B, 16, 16, 1)).astype(np.float32)
    gt[:, :3] = 0.0
    gt[1, :, :2] = 0.0
    return images, cams, gt, gt


def _halo_block_inputs(shape, rank3, rows=24, halo_ops=None):
    """Each halo op at an input level where the row blocks are uneven (and
    at level 0): a whole input of the level's size, a kernel (5x5(x5) for
    the 5x5 stride-2 kind "s2k5") and the cotangent of the whole output;
    the volume is 16 planes x `rows` rows x 5 columns at level 0 (3D), or
    `rows` x 5 (2D)."""
    rng = np.random.default_rng(9 + rank3)
    ops = {}
    for kind, level in halo_ops or [op for op in HALO_OPS if not (rank3 and op[0] == "s2k5")]:
        spatial = (16 >> level, rows >> level) if rank3 else (rows >> level,)
        x = rng.standard_normal((2, *spatial, 5, 8)).astype(np.float32)
        K = 5 if kind == "s2k5" else 3
        k = (rng.standard_normal((K,) * (len(spatial) + 1) + (8, 8)) / 10).astype(np.float32)
        out = [n * 2 if kind == "up" else -(-n // (1 if kind == "s1" else 2))
               for n in spatial] + [10 if kind == "up" else 5 if kind == "s1" else 3]
        cot = rng.standard_normal((2, *out, 8)).astype(np.float32)
        ops[f"{kind}{level}"] = (kind, level, x, k, cot)
    return {"shape": shape, "sizes": (16, rows) if rank3 else (rows,), "ops": ops}


# the 5x5 stride-2 kind at level 2 of 24 rows: blocks of 3 rows, so rank 0
# (an odd block end) reads three rows from rank 1. It runs on row blocks
# (2D) only, as the tower's conv9_0 and conv10_0: the port's transposed
# conv, its input gradient, takes 5x5 kernels in 2D only.
HALO_OPS = (("s1", 3), ("s2", 2), ("up", 3), ("s1", 0), ("s2", 0), ("up", 1), ("s2k5", 0),
            ("s2k5", 2))
HALO_CASES = ([("blocks3d", f"{k}{lv}") for k, lv in HALO_OPS if k != "s2k5"]
              + [("blocks2d", f"{k}{lv}") for k, lv in HALO_OPS])
# 40 rows: level 2 splits 5 / 5, and rank 0 reads rank 1's first three rows
# (the third not its last)
HALO_K5_ROWS = 40


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

        # refinement: seeded JAX variables (tests/test_torch_refine.py)
        self.refine_model = JaxMVSNet(JaxModelConfig(**REFINED))
        self.refined = {B: _scene(B, 16, seed=8 + B) for B in (1, 2)}
        r_images, r_cams, r_ds, r_di, _ = self.refined[1]
        self.refine_vars = seeded_variables(jax.eval_shape(
            lambda key: self.refine_model.init(key, r_images, r_cams, r_ds, r_di),
            jax.random.PRNGKey(0)), 14)
        self.refine_sd = {k: v.numpy() for k, v in state_dict_from_jax(self.refine_vars).items()}

        self.latency = {shape: _scene(1, 32) for shape in ((1, 4, 1), (1, 2, 2))}
        self.latency96 = _scene(1, 32, seed=12, H=96)
        self.serve96_model = JaxMVSNet(JaxModelConfig(**SERVE96))

        # the blocked train steps at D=16 (the same variables: no shape
        # depends on D); the refined step with the full-resolution depth
        self.train16_model = JaxMVSNet(JaxModelConfig(**TRAIN16))
        self.batch16 = _train_batch(D=16)
        rb_images, rb_cams = _scene(2, 16, seed=15)[:2]
        gt = np.random.default_rng(16).uniform(5.5, 12.0, (2, 64, 64, 1)).astype(np.float32)
        gt[:, :7] = 0.0
        self.refined_batch = (rb_images, rb_cams, gt[:, ::4, ::4].copy(), gt)
        rng = np.random.default_rng(17)
        self.tail_inputs = {"shape": (1, 2, 1), "tails": TAILS,
                            "reg": rng.standard_normal((2, 16, 6, 7)).astype(np.float32) * 3,
                            "range": (np.array([5.0, 4.0], np.float32),
                                      np.array([0.5, 0.25], np.float32),
                                      np.array([12.5, 7.75], np.float32))}
        self.fallback = _scene(1, 16)
        # 32x64 images on four 'space' ranks: the tower's level 4 has 2 rows,
        # so two ranks would hold none, and it runs whole
        self.tower_fallback = _scene(1, 32, seed=18, H=32)
        self.throughput = _scene(4, 32, seed=4)

        def predict(shape, inputs, cfg=SERVE):
            return ("predict", {"shape": shape, "cfg": cfg, "state_dict": sd,
                                "inputs": inputs})

        def train(shape, cfg=TRAIN, batch=self.batch, state_dict=tsd, tcfg=TCFG):
            return ("train", {"shape": shape, "cfg": cfg, "tcfg": tcfg,
                              "state_dict": state_dict, "batch": batch})
        cases4 = [("halo", _halo_inputs((1, 4, 1))),
                  ("halo", _halo_inputs((1, 2, 2))),
                  predict((1, 4, 1), self.latency[(1, 4, 1)]),
                  predict((1, 2, 2), self.latency[(1, 2, 2)]),
                  predict((1, 4, 1), self.fallback, dict(SERVE, max_d=16)),
                  predict(None, self.throughput),
                  train((2, 2, 1)),
                  ("default_device_error", None),
                  ("halo_blocks", _halo_block_inputs((1, 2, 2), True)),
                  predict((1, 2, 2), self.latency96, SERVE96),
                  ("audit", {"shape": (1, 2, 2), "cfg": AUDIT, "inputs": self.latency96}),
                  train((1, 2, 2), TRAIN16, self.batch16),
                  train((2, 1, 2), TRAIN16, self.batch16),
                  predict((1, 1, 4), self.tower_fallback, dict(SERVE, height=32))]
        gru_predict = [("predict", {"shape": None, "cfg": dict(GRU, network_mode="lite"),
                                    "state_dict": self.gru_sd, "inputs": self.gru_serve[B]})
                       for B in (1, 3)]
        gru_train = ("train", {"shape": (2, 1, 1), "cfg": dict(GRU, network_mode="ultralite"),
                               "tcfg": {}, "state_dict": self.gru_train_sd,
                               "batch": self.batch})
        refined = [("predict", {"shape": None, "cfg": REFINED, "state_dict": self.refine_sd,
                                "inputs": self.refined[B]}) for B in (1, 2)]
        cases2 = [predict(None, self.throughput), train((2, 1, 1)), *gru_predict, gru_train,
                  *refined,
                  ("halo_blocks", _halo_block_inputs((1, 1, 2), False)),
                  predict((1, 1, 2), self.latency96, SERVE96),
                  ("tail", self.tail_inputs),
                  train((1, 2, 1), TRAIN16, self.batch16),
                  train((1, 2, 1), REFINED, self.refined_batch, self.refine_sd, REFINED_TCFG),
                  train((1, 1, 2), dict(GRU, network_mode="lite"), self.batch, self.gru_sd, {}),
                  ("halo_blocks", _halo_block_inputs((1, 1, 2), False, HALO_K5_ROWS,
                                                     (("s2k5", 2),)))]
        self.index4 = {"halo4": 0, "halo2": 1, "latency141": 2, "latency122": 3,
                       "fallback": 4, "throughput": 5, "train": 6, "default_device_error": 7,
                       "blocks3d": 8, "latency96_122": 9, "audit": 10, "train122": 11,
                       "train212": 12, "tower_fallback": 13}
        self.index2 = {"throughput": 0, "train": 1, "gru1": 2, "gru3": 3, "gru_train": 4,
                       "refined1": 5, "refined2": 6, "blocks2d": 7, "latency96_112": 8,
                       "tail": 9, "train121": 10, "refined_train121": 11,
                       "gru_train112": 12, "blocks2d_k5": 13}
        self.state_dict = sd
        self.train_state_dict = tsd
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
        assert not any("gathering the volume" in m or "UNetDS2GN" in m for m in r["log"])
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


@pytest.mark.parametrize("B", [1, 2])
def test_refined_serving_on_two_ranks_matches_port_and_jax(world, B):
    """Refinement over the default (1, 2, 1) mesh of two ranks (JAX's
    tests/test_parallel.py:266): B=1 the latency regime, in which every
    rank refines the gathered maps whole, B=2 the throughput regime, each
    rank refining its own map. Every rank's refined depth, prob and
    residual against one device of the port, and rank 0's against JAX's
    `apply_forward_3dcnn` on the same variables."""
    inputs = world.refined[B]
    ranks = world.ranks(2, f"refined{B}")
    single = _port_single(inputs, REFINED, world.refine_sd)
    for r in ranks:
        assert r["mesh"] == (1, 2, 1) and r["depth"].shape == (B, 64, 64, 1)
        for key, want in zip(("depth", "prob", "residual"), single):
            np.testing.assert_allclose(r[key], want, **PORT)
    want = jax.jit(lambda v, *a: jax_apply_forward_3dcnn(world.refine_model, v, *a))(
        world.refine_vars, *inputs[:4])
    for key, w, tol in zip(("depth", "prob", "residual"), want, (2e-3, 5e-3, 2e-3)):
        np.testing.assert_allclose(ranks[0][key], np.asarray(w), rtol=tol, atol=tol)
    assert np.abs(ranks[0]["residual"]).max() > 0


@pytest.fixture(scope="module")
def jax_single_step(world):
    """JAX's single-device step on the training batch."""
    return _jax_step(world, None)


def _jax_step(world, shape, cfgd=TRAIN):
    cfg, tcfg = JaxModelConfig(**cfgd), JaxTrainConfig(**TCFG)
    model, v = (world.train_model, world.train_vars) if cfgd is TRAIN else \
        (world.train16_model, world.train_vars)
    batch = world.batch if cfgd is TRAIN else world.batch16
    state = jax_train.TrainState.create(apply_fn=model.apply, params=v["params"],
                                        batch_stats=v["batch_stats"],
                                        tx=jax_train.make_optimizer(tcfg))
    if shape is None:
        def loss_fn(p):
            return jax_train.compute_loss(model, cfg, tcfg, p, state.batch_stats,
                                          batch, True)
        grads, (stats, metrics) = jax.jit(jax.grad(loss_fn, has_aux=True))(state.params)
        return _numpy_tree(grads), _numpy_tree(stats), metrics
    # the sharded step: gradients and statistics from the updated state
    mesh = jax_make_mesh(int(np.prod(shape)), shape)
    try:
        step, mesh = jax_sharded_step(model, cfg, tcfg, mesh=mesh, donate=False)
        new_state, metrics = step(shard_state(state, mesh), batch)
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


def _place(results, key, field, bounds_of):
    """The whole tensor stitched from every rank's block of results[key]
    (each rank's `bounds_of` per spatial axis; None: whole)."""
    parts = {}
    for r in results:
        o = r[key]
        idx = tuple((0, None) if b is None else tuple(b) for b in o[bounds_of])
        parts[idx] = o[field]
    starts = [sorted({i[a][0] for i in parts}) for a in range(len(next(iter(parts))))]

    def build(axis, prefix):
        if axis == len(starts):
            return parts[tuple(prefix)]
        blocks = [build(axis + 1, prefix + [p]) for p in sorted(
            {i[axis] for i in parts if list(i[:axis]) == prefix})]
        return np.concatenate(blocks, axis=axis + 1)
    return build(0, [])


def _whole_op(kind, x, k, cot, bias=None):
    """The whole op on the plain path: its output, eval output with a bias
    and ReLU, dx and dk of sum(out * cot) through `ops/autograd.py`."""
    from mvsnet_tpu_torch.ops import autograd
    from mvsnet_tpu_torch.ops.kernels import conv as conv_k, deconv as deconv_k

    xt, kt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(k).requires_grad_(True)
    if kind == "up":
        y = autograd.DeconvFn.apply(xt, kt)
        y_eval = deconv_k.deconv(xt.detach(), kt.detach(), bias, True)
    else:
        stride = 1 if kind == "s1" else 2
        y = autograd.ConvFn.apply(xt, kt, stride)
        y_eval = conv_k.conv(xt.detach(), kt.detach(), bias, stride, True)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), y_eval.numpy(), xt.grad.numpy(), kt.grad.numpy()


def _assert_halo_blocks(ranks, op, inputs):
    """The ranks' blocks of one halo op (output, eval output, dx) stitched
    equal the whole op's; their shares of dk add up to its dk."""
    kind, _, x, k, cot = inputs
    bias = torch.linspace(-1, 1, k.shape[-1])
    y, y_eval, dx, dk = _whole_op(kind, x, k, cot, bias)
    np.testing.assert_allclose(_place(ranks, op, "y", "bounds"), y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_place(ranks, op, "y_eval", "bounds"), y_eval, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_place(ranks, op, "dx", "in_bounds"), dx, rtol=1e-6, atol=1e-5)
    got_dk = sum(r[op]["dk"] for r in ranks)
    assert np.abs(got_dk - dk).max() <= 1e-5 * np.abs(dk).max()


def _rows_read_from_next(rows, level, kind, q=0):
    """The places (1: row b, 2: b + 1, 3: b + 2) of the rows rank q of two
    'space' ranks over `rows` reads beyond its block's end b."""
    split = AxisSplit("space", rows, 2, q)
    return [k for _, k in halo._halo_rows(split, level, kind, q) if k > 0]


@pytest.mark.parametrize("case,op", HALO_CASES)
def test_halo_blocks_match_whole_op_and_its_gradients(world, case, op):
    """The halo ops on depth x space blocks (3D, mesh (1, 2, 2)) and on row
    blocks (2D, (1, 1, 2)) of 24 rows, uneven from level 3 (rows 2 + 1):
    each rank's block of the output, with and without bias + ReLU, and of
    dx equal the whole op's on the plain path, and the ranks' shares of dk
    add up to its dk. The 5x5 stride-2 kind at level 2 has an odd block end
    (3 rows a rank), where rank 0 reads three rows from rank 1."""
    ranks = [r for r in world.ranks(4 if case == "blocks3d" else 2, case)]
    inputs = _halo_block_inputs((1, 2, 2) if case == "blocks3d" else (1, 1, 2),
                                case == "blocks3d")["ops"][op]
    _assert_halo_blocks(ranks, op, inputs)
    if op in ("s13", "s22"):           # the blocks are uneven here
        assert len({np.prod(r[op]["y"].shape) for r in ranks}) > 1
    if op == "s2k52":
        assert _rows_read_from_next(24, 2, "s2k5") == [1, 2, 3]


def test_five_by_five_halo_reads_a_third_row(world):
    """The 5x5 stride-2 halo conv at level 2 of 40 rows on (1, 1, 2): blocks
    of 5 rows, so rank 0 reads rank 1's first, second and third rows (the
    third not its last: the packet's fourth slot); its blocks and gradients
    against the whole op as in test_halo_blocks_match_whole_op_and_its_gradients."""
    assert _rows_read_from_next(HALO_K5_ROWS, 2, "s2k5") == [1, 2, 3]
    split = AxisSplit("space", HALO_K5_ROWS, 2, 0)
    assert [halo._slot(split, 2, row) for row in (5, 6, 7)] == [(1, 0), (1, 1), (1, 3)]
    inputs = _halo_block_inputs((1, 1, 2), False, HALO_K5_ROWS, (("s2k5", 2),))
    _assert_halo_blocks(world.ranks(2, "blocks2d_k5"), "s2k52", inputs["ops"]["s2k52"])


def _jax_serve96(world, shape):
    images, cams, ds, di = (jnp.asarray(a) for a in world.latency96[:4])
    mesh = jax_make_mesh(int(np.prod(shape)), shape)
    try:
        return jax_sharded_forward(world.serve96_model, JaxModelConfig(**SERVE96), mesh)(
            world.serve_vars, images, cams, ds, di)[:2]
    finally:
        set_active_mesh(None)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2)])
def test_latency_blocks_at_height_96_match_port_and_jax(world, shape):
    """The latency regime on depth x space blocks at 96x64 (24 feature rows,
    uneven row blocks at the U-Net's deepest level): every rank's whole maps
    equal the port's single device within PORT and JAX's sharded forward on
    the same mesh shape within the models' tolerance; no axis falls back."""
    ranks = world.ranks(int(np.prod(shape)), f"latency96_{''.join(map(str, shape))}")
    single = _port_single(world.latency96, SERVE96, world.state_dict)
    for r in ranks:
        assert r["mesh"] == shape and r["depth"].shape == (1, 24, 16, 1)
        np.testing.assert_allclose(r["depth"], single[0], **PORT)
        np.testing.assert_allclose(r["prob"], single[1], **PORT)
        assert not any("RegNetUS0" in m or "UNetDS2GN" in m for m in r["log"]), r["log"]
    _assert_jax((ranks[0]["depth"], ranks[0]["prob"]), _jax_serve96(world, shape))


def test_no_rank_holds_a_whole_volume(world):
    """One latency request at 96x64, D=64 on (1, 2, 2), every tensor any op
    made on each rank recorded: none holds the whole (D, h, w) = (64, 24,
    16) volume in any layout, and the depth x space block (32, 12, 16) does
    the work (tests/test_parallel.py:78-136 checks JAX's compiled module
    so); none holds a whole (B·V, H/2^l, W/2^l, C) feature-tower map at any
    level l of 0-4 (the replicated images exempt), and the half-row block
    (B·V, H/2^(l+1), W/2^l, C) does the work at every level."""
    D, h, w = 64, 24, 16
    N, H, W = 3, 96, 64
    for r in world.ranks(4, "audit"):
        shapes = [tuple(s) for s in r["shapes"]]
        whole = rank_checks.whole_volume_shapes(shapes, D, h, w)
        assert not whole, f"rank {r['coords']}: whole-volume tensors {whole}"
        assert any(s[:4] == (1, D // 2, h // 2, w) for s in shapes), shapes
        maps = rank_checks.whole_tower_shapes(shapes, N, H, W)
        assert not maps, f"rank {r['coords']}: whole tower maps {maps}"
        for lv in range(5):
            assert any(len(s) == 4 and s[:3] == (N, (H >> lv) // 2, W >> lv) and s[3] != 3
                       for s in shapes), (lv, shapes)
        assert np.isfinite(r["depth"]).all() and r["depth"].shape == (1, h, w, 1)


@pytest.mark.parametrize("tail", TAILS)
def test_collective_tail_matches_soft_argmin_prob_map(world, tail):
    """The collective soft-argmin tail over two depth slabs (2 and 4
    buckets, inverse depth) equals `soft_argmin_prob_map` of the whole
    volume on every rank, up to the order of the sums."""
    from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map

    inp = world.tail_inputs
    buckets, inverse = tail
    ds, di, de = (torch.from_numpy(a) for a in inp["range"])
    want = soft_argmin_prob_map(torch.from_numpy(inp["reg"]), ds, di, 16, inverse, de, buckets)
    for r in world.ranks(2, "tail"):
        for got, w in zip(r[tail], want):
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_single_step16(world):
    """JAX's single-device step at D=16 on the blocked steps' batch."""
    return _jax_step(world, None, TRAIN16)


def _port_single_step(cfgd, tcfgd, state_dict, batch):
    cfg, tcfg = ModelConfig(**cfgd), TrainConfig(**tcfgd)
    model = MVSNet(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    _, metrics = train_lib.make_train_step(model, cfg, tcfg)(state, batch)
    return model, metrics


def _assert_port_step(r, model, metrics, vanishing=False):
    """A blocked step's rank against the port's single step: loss 1e-5,
    each leaf 1e-4 of its largest entry (with `vanishing`, leaves whose
    gradient vanishes analytically held under 1e-6 of the largest)."""
    np.testing.assert_allclose(r["metrics"]["loss"], metrics["loss"].item(), rtol=1e-5)
    for k in ("less_one", "less_three"):
        np.testing.assert_allclose(r["metrics"][k], metrics[k].item(), atol=1e-6)
    top = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        scale, got = float(p.grad.abs().max()), r["grads"][name]
        if vanishing and max(scale, float(np.abs(got).max())) <= 1e-6 * top:
            continue
        assert float(np.abs(got - p.grad.numpy()).max()) <= 1e-4 * max(scale, 1e-12), name
    for name, b in model.named_buffers():
        np.testing.assert_allclose(r["buffers"][name], b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", BLOCK_TRAIN)
def test_blocked_train_step_matches_jax_and_port(world, jax_single_step16, shape):
    """The 3D-CNN train step with the volume in blocks over 'depth' x
    'space' (D=16: one plane a rank at the U-Net's deepest level) against
    JAX's single-device step and JAX's sharded step on the same mesh shape
    (tolerances of test_sharded_train_step_matches_jax) and against the
    port's single step (loss 1e-5, leaves 1e-4); equal statistics and
    parameters on every rank; each rank's cost volume is its block (B/data,
    D/depth, h/space, w, C), none the whole."""
    ranks = world.ranks(int(np.prod(shape)), "train" + "".join(map(str, shape)))
    block = (2 // shape[0], 16 // shape[1], 16 // shape[2], 16, 8)      # ultralite: C = 8
    assert all(r["costs"] == [block] for r in ranks), [r["costs"] for r in ranks]
    grads, stats, metrics = jax_single_step16
    model, port_metrics = _port_single_step(TRAIN16, TCFG, world.train_state_dict,
                                            world.batch16)
    for r in ranks:
        assert not any("UNetDS2GN" in m for m in r["log"]), r["log"]
        np.testing.assert_allclose(r["metrics"]["loss"], float(metrics["loss"]), rtol=1e-4)
        _assert_grads(r["grads"], grads)
        _assert_stats(r["buffers"], stats)
        _assert_port_step(r, model, port_metrics)
        for name, p in r["params"].items():
            np.testing.assert_array_equal(p, ranks[0]["params"][name], err_msg=name)
        for name, b in r["buffers"].items():
            np.testing.assert_array_equal(b, ranks[0]["buffers"][name], err_msg=name)
    _, sharded_stats, sharded_metrics = _jax_step(world, shape, TRAIN16)
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(sharded_metrics["loss"]),
                               rtol=1e-4)
    _assert_stats(ranks[0]["buffers"], sharded_stats)


def test_blocked_refined_train_step_matches_port(world):
    """The refined 3D-CNN step ("all" mode, the U-Net upsampled with
    confidence, against the full-resolution depth) with the volume in
    depth slabs on (1, 2, 1): the refinement net runs on the gathered maps
    alike on both ranks; against the port's single step."""
    model, metrics = _port_single_step(REFINED, REFINED_TCFG, world.refine_sd,
                                       world.refined_batch)
    assert any(p.grad.abs().max() > 0 for n, p in model.named_parameters()
               if n.startswith("refine_net."))
    for r in world.ranks(2, "refined_train121"):
        _assert_port_step(r, model, metrics)


def test_blocked_gru_train_step_matches_port_and_jax(world):
    """R-MVSNet's train step with the sweep's rows over two 'space' ranks
    (1, 1, 2), JAX's variables ("lite"): against the port's single step
    under test_sharded_gru_train_step_matches_single's bounds, and its loss
    and metrics against JAX's sharded step on (1, 1, 2) (1e-4 relative)."""
    cfgd = dict(GRU, network_mode="lite")
    model, metrics = _port_single_step(cfgd, {}, world.gru_sd, world.batch)
    ranks = world.ranks(2, "gru_train112")
    for r in ranks:
        assert not any("UNetDS2GN" in m for m in r["log"]), r["log"]
        _assert_port_step(r, model, metrics, vanishing=True)
    cfg, tcfg = world.gru_cfg, JaxTrainConfig()
    state = jax_train.TrainState.create(apply_fn=world.gru_model.apply,
                                        params=world.gru_vars["params"], batch_stats={},
                                        tx=jax_train.make_optimizer(tcfg))
    mesh = jax_make_mesh(2, (1, 1, 2))
    try:
        step, mesh = jax_sharded_step(world.gru_model, cfg, tcfg, mesh=mesh, donate=False)
        _, want = step(shard_state(state, mesh), world.batch)
    finally:
        set_active_mesh(None)
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(want["loss"]), rtol=1e-4)
    for k in ("less_one", "less_three"):
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(want[k]), atol=1e-6)


def test_blocked_gru_train_step_recomputes_the_sweep(world):
    """The blocked GRU train step on (1, 1, 2) runs its sweep as JAX's
    partitioned program does, recomputing each depth step in the backward
    pass (`GRUSweep.remat`), once a step on each rank, as does the data
    parallel one on (2, 1, 1); the 3D-CNN's steps run no sweep."""
    for case in ("gru_train112", "gru_train"):
        assert all(r["sweeps"] == ["remat"] for r in world.ranks(2, case))
    for case in ("train", "train121"):
        assert all(r["sweeps"] == [] for r in world.ranks(2, case))


def _jax_tower_rows(hlo):
    """{layer: (forward rows, backward rows)} of the feature tower's
    convolutions in a partitioned HLO module: the rows (the output's first
    spatial dimension, from `dim_labels`) of each convolution whose op name
    runs through feature_net/<layer>, the backward ones (under
    `transpose(`) apart."""
    import re

    rows = {}
    for line in hlo.splitlines():
        if " convolution(" not in line or "feature_net/" not in line:
            continue
        op_name = re.search(r'op_name="([^"]*)"', line).group(1)
        layer = re.search(r"feature_net/([^/]+)/", op_name).group(1)
        dims = [int(d) for d in re.search(r"= \w+\[([\d,]+)\]", line).group(1).split(",")]
        out_labels = re.search(r"dim_labels=\S*->(\w+)", line).group(1)
        fwd, bwd = rows.setdefault(layer, (set(), set()))
        (bwd if "transpose(" in op_name else fwd).add(dims[out_labels.index("0")])
    return rows


def _jax_latency_hlo(world, shape):
    images, cams, ds, di = (jnp.asarray(a) for a in world.latency96[:4])
    mesh = jax_make_mesh(int(np.prod(shape)), shape)
    try:
        fwd = jax_sharded_forward(world.serve96_model, JaxModelConfig(**SERVE96), mesh)
        variables = jax.device_put(world.serve_vars, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
        return fwd.jit_for(1).lower(variables, images, cams, ds, di).compile().as_text()
    finally:
        set_active_mesh(None)


def _jax_train_hlo(world, shape):
    cfg, tcfg = JaxModelConfig(**TRAIN16), JaxTrainConfig(**TCFG)
    v = world.train_vars
    state = jax_train.TrainState.create(apply_fn=world.train16_model.apply, params=v["params"],
                                        batch_stats=v["batch_stats"],
                                        tx=jax_train.make_optimizer(tcfg))
    mesh = jax_make_mesh(int(np.prod(shape)), shape)
    try:
        step, mesh = jax_sharded_step(world.train16_model, cfg, tcfg, mesh=mesh, donate=False)
        return step.lower(shard_state(state, mesh), world.batch16).compile().as_text()
    finally:
        set_active_mesh(None)


@pytest.mark.parametrize("program", ["latency122", "latency112", "train122"])
def test_tower_rows_match_jax_partitioned_programs(world, program):
    """The layout of the feature tower over 'space' against JAX's compiled,
    partitioned programs on the same mesh shape (tests/test_parallel.py:
    78-136 compiles them so): latency serving at 96x64 on (1, 2, 2) and
    (1, 1, 2), and the blocked 3D-CNN train step at 64x64 on (1, 2, 2).
    For every layer of UNetDS2GN the rows of JAX's forward convolution
    equal those of the port rank's output block for that layer, and the
    rows of JAX's backward (transposed) convolutions those of the rank's
    input block, the rows whose gradient it keeps; every rank's rows are
    the same (the blocks are even here), and a whole map has twice them."""
    if program.startswith("latency"):
        shape = tuple(int(c) for c in program[-3:])
        ranks = world.ranks(int(np.prod(shape)), f"latency96_{program[-3:]}")
        jax_rows, H = _jax_tower_rows(_jax_latency_hlo(world, shape)), 96
    else:
        shape = (1, 2, 2)
        ranks = world.ranks(4, "train122")
        jax_rows, H = _jax_tower_rows(_jax_train_hlo(world, shape)), 64
    port = [r["tower_rows"] for r in ranks]
    assert all(p == port[0] for p in port), port
    names = [name for name, _, _ in feature_net.TOWER_LAYERS]
    assert sorted(jax_rows) == sorted(names) == sorted(port[0])
    for name, level, kind in feature_net.TOWER_LAYERS:
        fwd, bwd = jax_rows[name]
        rows_in, rows_out = port[0][name]
        assert rows_out == (H >> feature_net.output_level(level, kind)) // 2, name
        assert fwd == {rows_out}, (name, fwd, rows_out)
        if bwd:                         # the two convs on the images have no dx
            assert bwd == {rows_in}, (name, bwd, rows_in)
    if program.startswith("train"):
        assert sum(bool(b) for _, b in jax_rows.values()) == len(names) - 2


def test_tower_runs_whole_where_rows_cannot_split(world):
    """32x64 images on (1, 1, 4): 8 feature rows, 2 a rank, but the tower's
    level 4 has 2 rows for four ranks, so it runs whole on every rank and
    keeps the rank's rows, and the log says so; the maps equal the single
    device's (the U-Net gathers its rows too, as plan_volume says)."""
    ranks = world.ranks(4, "tower_fallback")
    single = _port_single(world.tower_fallback, dict(SERVE, height=32), world.state_dict)
    for r in ranks:
        assert any("UNetDS2GN" in m and "runs the whole tower" in m for m in r["log"]), r["log"]
        assert r["tower_rows"]["conv10_2"] == (8, 8)
        np.testing.assert_allclose(r["depth"], single[0], **PORT)
        np.testing.assert_allclose(r["prob"], single[1], **PORT)
