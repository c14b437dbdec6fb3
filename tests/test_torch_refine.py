"""Depth refinement in the port (`models/refine.py`, `MVSNet.refine`,
`ops/resize.py`, the refinement branches of `apply_forward_3dcnn` and
`train_lib.compute_loss`) against the JAX package on the CPU, on the same
seeded numpy inputs and weights (64x64 images, D=8, V=3, float32;
`ultralite` or `lite`).

JAX's variables come from `jax.eval_shape` of the module's init, filled
from a seeded numpy generator (kernels N(0, 1/fan_in), biases 0.1 N(0, 1),
norm scales and running variances in [0.5, 1.5), running means 0.2 N(0,
1)): the init's tree without its compile time. They load into the port
through `convert.state_dict_from_jax`, strictly where a whole model loads.

Tolerances: the resize, elementwise float32 arithmetic, 1e-5; a refinement
net (4 to 28 float32 convs, sums in another order) 1e-4 absolute and
relative; the 3D-CNN graph with refinement the golden fixture's (depth and
residual 2e-3, prob 5e-3, tests/test_golden.py); a train step as
tests/test_torch_train.py holds the 3D-CNN's (loss 1e-4 relative, <1px and
<3px 1e-6, each gradient leaf 1e-3 of its own largest entry).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import tiny_inputs  # noqa: E402

from mvsnet_tpu import train_lib as jax_train  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu.models import refine as jax_refine  # noqa: E402
from mvsnet_tpu.models.mvsnet import apply_forward_3dcnn as jax_apply_forward_3dcnn  # noqa: E402
from mvsnet_tpu_torch import train_lib  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet, apply_forward_3dcnn  # noqa: E402
from mvsnet_tpu_torch.models import refine  # noqa: E402
from mvsnet_tpu_torch.ops.resize import resize_bilinear  # noqa: E402

TINY = dict(view_num=3, max_d=8, width=64, height=64, compute_dtype="float32")
NET = dict(atol=1e-4, rtol=1e-4)
# the training driver's defaults (mvsnet_tpu/train.py:57-65)
DRIVER_REFINE = dict(refinement=True, refinement_network="unet",
                     upsample_before_refinement=True, refine_with_confidence=True)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def seeded_variables(shapes, seed):
    """A variables tree of `shapes` (ShapeDtypeStructs) filled from
    numpy's generator `seed`; see the module docstring."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name in ("scale", "var"):
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _scene():
    """Three views with a baseline (`tests/test_torch_models.py`'s scene)."""
    images, cams, ds, di = tiny_inputs()
    cams = np.array(cams, np.float32)
    cams[0, 1, 0, 0, 3] += 0.4
    cams[0, 2, 0, 1, 3] -= 0.3
    return np.array(images), cams, np.array(ds), np.array(di)


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("src,dst", [((12, 20), (48, 80)), ((48, 80), (12, 20)),
                                     ((17, 13), (40, 31)), ((40, 31), (17, 13)),
                                     ((16, 24), (16, 96))])
def test_resize_matches_jax_image_resize(src, dst):
    """Up (4x), down (1/4, through the antialiasing triangle filter) and
    non-integer scales at non-square shapes; one axis kept."""
    x = np.random.default_rng(0).standard_normal((2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst + (3,), "bilinear"))
    got = resize_bilinear(_t(x), *dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if dst[0] < src[0]:
        # the trap: plain bilinear interpolation does not antialias
        plain = F.interpolate(_t(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(plain - want).max() > 1e-2


# ---------------------------------------------------------------- nets


@pytest.mark.parametrize("cls,training", [("RefineNet", False), ("RefineNet", True),
                                          ("RefineNetConv", False), ("RefineUNet", False),
                                          ("RefineUNetConv", False)])
def test_refine_net_matches_jax(cls, training):
    """Each refinement net (`lite`) on an image and two data channels,
    32x48 (the U-Net's four halvings); the batch-norm net also in training
    mode (batch statistics, running statistics updated)."""
    rng = np.random.default_rng(1)
    color = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    data = rng.random((2, 32, 48, 2)).astype(np.float32)
    net = getattr(jax_refine, cls)("lite", dtype="float32")
    v = seeded_variables(jax.eval_shape(lambda k: net.init(k, color, data), jax.random.PRNGKey(0)),
                         2)
    if training:
        want, new = net.apply(v, color, data, True, mutable=["batch_stats"])
    else:
        want, new = net.apply(v, color, data, False), {}
    port = getattr(refine, cls)(5, "lite", dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax(v))
    port.train(training)
    with torch.no_grad():
        got = port(_t(color), _t(data))
    assert got.shape == (2, 32, 48, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET)
    buffers = dict(port.named_buffers())
    for name, stat in state_dict_from_jax(dict(new)).items():
        np.testing.assert_allclose(buffers[name].numpy(), stat.numpy(), atol=1e-5, rtol=1e-5)


REFINE_CASES = [
    # network, upsample_before_refinement, confidence, stereo, residual
    ("unet", True, True, False, True),
    ("unet", False, True, True, True),       # image and stereo view resized down 4x
    ("unet", False, False, False, False),
    ("original", True, False, True, False),
    ("original", False, True, False, True),
]


@pytest.mark.parametrize("net,up,conf,stereo,residual", REFINE_CASES)
def test_mvsnet_refine_matches_jax(net, up, conf, stereo, residual):
    """`MVSNet.refine` (`ultralite`): the depth normalised, resized with
    the image or the image with it, the confidence and stereo channels,
    the residual added or not."""
    kw = dict(refinement=True, refinement_network=net, upsample_before_refinement=up,
              refine_with_confidence=conf, refine_with_stereo=stereo,
              residual_refinement=residual, network_mode="ultralite", **TINY)
    images, _, ds, di = _scene()
    rng = np.random.default_rng(3)
    depth = rng.uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    prob = rng.random((1, 16, 16, 1)).astype(np.float32)
    args = (depth, images[:, 0], prob, ds, di)
    sv = images[:, 1] if stereo else None
    model = JaxMVSNet(JaxModelConfig(**kw))
    v = seeded_variables(jax.eval_shape(
        lambda k: model.init(k, *args, stereo_image=sv, method=JaxMVSNet.refine),
        jax.random.PRNGKey(0)), 4)
    want = model.apply(v, *args, stereo_image=sv, method=JaxMVSNet.refine)

    port = MVSNet(ModelConfig(**kw))
    missing, unexpected = port.load_state_dict(state_dict_from_jax(v), strict=False)
    assert not unexpected and not [k for k in missing if k.startswith("refine_net.")]
    with torch.no_grad():
        got = port.refine(*map(_t, args), stereo_image=None if sv is None else _t(sv))
    side = 64 if up else 16
    for g, w in zip(got, want):
        assert g.shape == (1, side, side, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **NET)
    if not residual:
        assert torch.equal(got[0], got[1])


def test_refine_unet_shape_is_checked():
    """The U-Net's four stride-2 levels: a refinement resolution that does
    not divide by 16 raises, naming it (JAX fails in a concat)."""
    cfg = ModelConfig(network_mode="ultralite", **TINY,
                      **dict(DRIVER_REFINE, upsample_before_refinement=False))
    model = MVSNet(cfg)
    depth = torch.full((1, 24, 16, 1), 6.0)
    with pytest.raises(ValueError, match="24x16"):
        model.refine(depth, torch.zeros(1, 96, 64, 3), torch.ones_like(depth), 5.0, 0.5)


# ------------------------------------------------------ whole graph, loss


@pytest.fixture(scope="module")
def driver_model():
    """The JAX 3D-CNN model with the driver's refinement defaults
    (`ultralite`) and seeded variables."""
    cfg = JaxModelConfig(network_mode="ultralite", **TINY, **DRIVER_REFINE)
    model = JaxMVSNet(cfg)
    images, cams, ds, di = _scene()
    shapes = jax.eval_shape(lambda k: model.init(k, images, cams, ds, di, training=True),
                            jax.random.PRNGKey(0))
    return cfg, model, seeded_variables(shapes, 5)


@pytest.mark.parametrize("kw", [DRIVER_REFINE,
                                dict(refinement=True, refinement_network="original",
                                     upsample_before_refinement=False,
                                     refine_with_stereo=True)])
def test_apply_forward_3dcnn_with_refinement_matches_jax(driver_model, kw):
    """The eval graph with refinement through `apply_forward_3dcnn`: the
    driver's defaults (upsampled, confidence) and the original net with the
    stereo view at the cost volume's resolution. The whole state dict loads
    strictly."""
    images, cams, ds, di = _scene()
    if kw is DRIVER_REFINE:
        _, model, v = driver_model
    else:
        model = JaxMVSNet(JaxModelConfig(network_mode="ultralite", **TINY, **kw))
        v = seeded_variables(jax.eval_shape(
            lambda k: model.init(k, images, cams, ds, di), jax.random.PRNGKey(0)), 6)
    want = jax.jit(lambda v, *a: jax_apply_forward_3dcnn(model, v, *a))(v, images, cams, ds,
                                                                         di)
    port = MVSNet(ModelConfig(network_mode="ultralite", **TINY, **kw))
    port.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got = apply_forward_3dcnn(port, *map(_t, (images, cams, ds, di)))
    for g, w, tol in zip(got, want, (2e-3, 5e-3, 2e-3)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=tol)
    assert not torch.equal(got[2], torch.zeros_like(got[2]))


MODES = ("all", "refine_only", "main_only")


def _train_batch():
    images, cams, _, _ = _scene()
    rng = np.random.default_rng(7)
    gt = rng.uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    gt[0, :3] = 0.0
    full = np.repeat(np.repeat(gt, 4, axis=1), 4, axis=2)
    return images, cams, gt, full


@pytest.fixture(scope="module")
def jax_losses(driver_model):
    """JAX's `compute_loss` metrics and gradients in each
    `refinement_train_mode`, one jitted program."""
    cfg, model, v = driver_model
    batch = _train_batch()

    def run(params):
        out = {}
        for mode in MODES:
            tcfg = JaxTrainConfig(refinement_train_mode=mode)
            out[mode] = jax.grad(lambda p: jax_train.compute_loss(
                model, cfg, tcfg, p, v["batch_stats"], batch, True), has_aux=True)(params)
        return out
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(v["params"]))


@pytest.mark.parametrize("mode", MODES)
def test_train_step_with_refinement_matches_jax(driver_model, jax_losses, mode):
    """One `make_train_step` with refinement against JAX's `compute_loss`
    in each mode: the refined map's loss against the full-resolution depth
    (upsampled net), mixed with the main map's; <1px and <3px the refined
    map's, or the main map's in "main_only"; every parameter's gradient,
    the refinement net's included."""
    _, _, v = driver_model
    grads, (_, metrics) = jax_losses[mode]
    cfg = ModelConfig(network_mode="ultralite", **TINY, **DRIVER_REFINE)
    tcfg = TrainConfig(refinement_train_mode=mode)
    model = MVSNet(cfg)
    model.load_state_dict(state_dict_from_jax(v))
    state = train_lib.create_train_state(model, cfg, tcfg, device="cpu")
    _, got = train_lib.make_train_step(model, cfg, tcfg)(state, _train_batch())
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["debug"].item(), float(metrics["debug"]), rtol=1e-4)
    for k in ("less_one", "less_three"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), atol=1e-6)
    want_grads = state_dict_from_jax({"params": grads})
    named = dict(model.named_parameters())
    assert set(want_grads) == set(named)
    assert any(k.startswith("refine_net.") for k in want_grads)
    for name, want in want_grads.items():
        scale = max(float(want.abs().max()), 1e-30)
        err = float((named[name].grad - want).abs().max())
        assert err <= 1e-3 * scale, f"{name}: max err {err:.3e}, max |grad| {scale:.3e}"


def test_main_only_metrics_are_the_main_maps():
    """In "main_only" <1px and <3px are the main map's and the refined
    map's loss weighs 1e-12; in "all" they are the refined map's."""
    cfg = ModelConfig(network_mode="ultralite", **TINY, **DRIVER_REFINE)
    batch = train_lib.to_device(_train_batch(), "cpu")
    model = MVSNet(cfg, seed=1)
    out = {mode: train_lib.compute_loss(model, cfg, TrainConfig(refinement_train_mode=mode),
                                        batch, training=False)[1] for mode in MODES}
    plain = dataclasses.replace(cfg, refinement=False)
    main = MVSNet(plain, seed=1)
    main.load_state_dict({k: t for k, t in model.state_dict().items()
                          if not k.startswith("refine_net.")})
    _, want = train_lib.compute_loss(main, plain, TrainConfig(), batch, training=False)
    for k in ("less_one", "less_three"):
        assert out["main_only"][k].item() == want[k].item()
    np.testing.assert_allclose(out["main_only"]["loss"].item(), want["loss"].item(), rtol=1e-6)
