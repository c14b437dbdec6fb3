"""The rest of the JAX package's public surface in the port, against JAX on
the CPU, on the same seeded numpy inputs and weights: the UniNetDS2 and
UniNetDS2GN towers, edge-clamped sampling (`bilinear_sample`,
`homography_warp`, `warp_by_homographies`), `cost_slice`,
`ops.geometry.scale_camera`, `power_loss(no_interval_norm=)` and
`gradient_loss(log=)`.

Tolerances, float32 on both sides: sampling and warps are short
elementwise sums over coordinates from small matmuls taken in another
order (1e-4 absolute on values of order 1, as tests/test_torch_ops.py
holds the zero-fill sampler); a cost slice is their squares (1e-4); a
tower is 8 float32 convs (1e-4 absolute and relative, the refinement
nets' bound in tests/test_torch_refine.py); scale_camera is one multiply
(exact); the losses are sums over a 24x32 map (1e-5 relative).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_ops import _cams  # noqa: E402
from test_torch_refine import seeded_variables  # noqa: E402

from mvsnet_tpu import losses as jlosses  # noqa: E402
from mvsnet_tpu.models import feature_net as jfeature  # noqa: E402
from mvsnet_tpu.ops import cost_volume as jcv  # noqa: E402
from mvsnet_tpu.ops import geometry as jgeo  # noqa: E402
from mvsnet_tpu.ops import warp as jwarp  # noqa: E402
from mvsnet_tpu_torch import losses  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.models import feature_net  # noqa: E402
from mvsnet_tpu_torch.ops import cost_volume as tcv  # noqa: E402
from mvsnet_tpu_torch.ops import geometry as tgeo  # noqa: E402
from mvsnet_tpu_torch.ops import warp as twarp  # noqa: E402

SAMPLE = dict(atol=1e-4, rtol=0)
NET = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _homs(rng, B, D, H=16, W=24):
    cams = _cams(rng, B=B, V=2, W=W, H=H)
    hom = jgeo.homographies_for_views(jnp.asarray(cams), D, jnp.full((B,), 4.0),
                                      jnp.full((B,), 0.7))
    return np.asarray(hom)[0]                     # (B, D, 3, 3)


@pytest.mark.parametrize("fill_mode", ["zeros", "edge"])
def test_bilinear_sample_fill_modes(fill_mode):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((10, 12, 4)).astype(np.float32)
    # inside, on the border and far outside on every side
    x = rng.uniform(-8, 20, 500).astype(np.float32)
    y = rng.uniform(-8, 18, 500).astype(np.float32)
    want = jwarp.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), fill_mode)
    got = twarp.bilinear_sample(_t(img), _t(x), _t(y), fill_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLE)


def test_bilinear_sample_rejects_other_fill_modes():
    with pytest.raises(ValueError, match="fill_mode"):
        twarp.bilinear_sample(torch.zeros(2, 2, 1), torch.zeros(1), torch.zeros(1), "wrap")


@pytest.mark.parametrize("fill_mode", ["zeros", "edge"])
def test_homography_warp(fill_mode):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 16, 24, 4)).astype(np.float32)
    hom = _homs(rng, 2, 1)[:, 0]
    want = jwarp.homography_warp(jnp.asarray(img), jnp.asarray(hom), fill_mode)
    got = twarp.homography_warp(_t(img), _t(hom), fill_mode)
    assert got.shape == (2, 16, 24, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLE)


@pytest.mark.parametrize("fill_mode", ["zeros", "edge"])
def test_warp_by_homographies(fill_mode):
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 16, 24, 8)).astype(np.float32)
    homs = _homs(rng, 2, 5)
    want = jwarp.warp_by_homographies(jnp.asarray(img), jnp.asarray(homs), fill_mode)
    got = twarp.warp_by_homographies(_t(img), _t(homs), fill_mode)
    assert got.shape == (2, 5, 16, 24, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLE)


@pytest.mark.parametrize("fill_mode", ["zeros", "edge"])
def test_cost_slice(fill_mode):
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((2, 16, 24, 8)).astype(np.float32)
    views = rng.standard_normal((2, 2, 16, 24, 8)).astype(np.float32)
    homs = np.stack([_homs(rng, 2, 1)[:, 0] for _ in range(2)])          # (V-1, B, 3, 3)
    want = jcv.cost_slice(jnp.asarray(ref), jnp.asarray(views), jnp.asarray(homs), fill_mode)
    got = tcv.cost_slice(_t(ref), _t(views), _t(homs), fill_mode)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 24, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLE)


def test_cost_slice_is_a_plane_of_the_volume():
    """Zero fill: the slice at one depth equals that plane of the fused
    cost volume (the kernel's plain version)."""
    rng = np.random.default_rng(4)
    ref = _t(rng.standard_normal((1, 16, 24, 8)))
    views = _t(rng.standard_normal((2, 1, 16, 24, 8)))
    homs = _t(np.stack([_homs(rng, 1, 3) for _ in range(2)]))          # (V-1, B, D, 3, 3)
    volume = tcv.plane_sweep_cost_volume(ref, views, homs)
    got = tcv.cost_slice(ref, views, homs[:, :, 1])
    np.testing.assert_allclose(got.numpy(), volume[:, 1].numpy(), atol=1e-5)


@pytest.mark.parametrize("batched", [False, True])
def test_scale_camera(batched):
    cams = _cams(np.random.default_rng(5), B=2, V=3)
    cams = cams if batched else cams[0, 0]
    want = np.asarray(jgeo.scale_camera(jnp.asarray(cams), 0.25))
    got = tgeo.scale_camera(torch.from_numpy(cams), 0.25)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(got.numpy(), cams)            # the input is untouched


def _depths(seed):
    rng = np.random.default_rng(seed)
    y_true = rng.uniform(400, 900, (2, 24, 32, 1)).astype(np.float32)
    y_true[rng.random(y_true.shape) < 0.2] = 0.0
    y_pred = (y_true + rng.standard_normal(y_true.shape) * 8).astype(np.float32)
    return y_true, y_pred, np.array([2.5, 3.0], np.float32)


@pytest.mark.parametrize("no_interval_norm", [False, True])
@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_power_loss_interval_norm(no_interval_norm, beta):
    y_true, y_pred, interval = _depths(6)
    want = jlosses.power_loss(jnp.asarray(y_true), jnp.asarray(y_pred), jnp.asarray(interval),
                              0.5, beta, no_interval_norm=no_interval_norm)
    got = losses.power_loss(_t(y_true), _t(y_pred), _t(interval), 0.5, beta,
                            no_interval_norm=no_interval_norm)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("log", [True, False])
def test_gradient_loss_log(log):
    y_true, y_pred, _ = _depths(7)
    want = jlosses.gradient_loss(jnp.asarray(y_true), jnp.asarray(y_pred), log=log)
    got = losses.gradient_loss(_t(y_true), _t(y_pred), log=log)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("cls", ["UniNetDS2", "UniNetDS2GN"])
def test_uninet_towers(cls, training):
    """Seeded JAX variables load into the port's tower by
    `state_dict_from_jax`; eval folds the batch norms into the convs, train
    mode uses the batch's statistics and moves the running ones as flax's."""
    x = np.random.default_rng(8).standard_normal((2, 32, 40, 3)).astype(np.float32)
    net = getattr(jfeature, cls)(network_mode="lite")
    bn = cls == "UniNetDS2"
    args = (x, training) if bn else (x,)
    v = seeded_variables(jax.eval_shape(lambda k: net.init(k, *args), jax.random.PRNGKey(0)), 9)
    if bn and training:
        want, new = net.apply(v, *args, mutable=["batch_stats"])
    else:
        want, new = net.apply(v, *args), {}
    port = getattr(feature_net, cls)("lite", dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax(v))
    port.train(training)
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == (2, 8, 10, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET)
    buffers = dict(port.named_buffers())
    for name, stat in state_dict_from_jax(dict(new)).items():
        np.testing.assert_allclose(buffers[name].numpy(), stat.numpy(), atol=1e-5, rtol=1e-5)


def test_plane_sweep_cost_volume_takes_jax_arguments(monkeypatch):
    """JAX's parameters in JAX's order: a fourth positional argument is
    `depth_chunk` (it used to bind to `differentiable` and select the
    autograd path), `fill_mode="edge"` warps edge-clamped, `out_dtype`
    casts, `cw_out` permutes to (B, D, h, C, w); all against JAX."""
    rng = np.random.default_rng(6)
    ref = rng.standard_normal((2, 16, 24, 8)).astype(np.float32)
    views = rng.standard_normal((2, 2, 16, 24, 8)).astype(np.float32)
    homs = np.stack([_homs(rng, 2, 4) for _ in range(2)])             # (V-1, B, D, 3, 3)
    j = [jnp.asarray(a) for a in (ref, views, homs)]
    t = [_t(a) for a in (ref, views, homs)]

    def no_autograd(*args):
        raise AssertionError("the autograd path was selected")

    monkeypatch.setattr(tcv.CostVolumeFn, "apply", no_autograd)
    got = tcv.plane_sweep_cost_volume(*t, 4)
    want = np.asarray(jcv.plane_sweep_cost_volume(*j, 4))
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE)
    for kwargs in (dict(fill_mode="edge", cw_out=True),
                   dict(out_dtype=jnp.bfloat16, cw_out=True, depth_chunk=2, use_pallas=False)):
        want = np.asarray(jcv.plane_sweep_cost_volume(*j, **kwargs).astype(jnp.float32))
        bf16 = "out_dtype" in kwargs
        got = tcv.plane_sweep_cost_volume(*t, **dict(kwargs, out_dtype=torch.bfloat16)
                                          if bf16 else kwargs)
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert got.shape == want.shape == (2, 4, 16, 8, 24), kwargs
        tol = dict(atol=1e-4, rtol=2 ** -7) if bf16 else SAMPLE
        np.testing.assert_allclose(got.float().numpy(), want, **tol, err_msg=str(kwargs))
        if not bf16:          # and without the permutation: the (B, D, h, w, C) volume
            got = tcv.plane_sweep_cost_volume(*t, fill_mode="edge")
            np.testing.assert_allclose(got.numpy(), np.swapaxes(want, -1, -2), **SAMPLE)
    with pytest.raises(ValueError, match="fill_mode"):
        tcv.plane_sweep_cost_volume(*t, fill_mode="wrap")


def test_dense_dropout_and_pools():
    """`Fc` with JAX's variables carried across by `state_dict_from_jax`,
    `Dropout`, and `max_pool`, `avg_pool` (divided by the taps inside the
    image) and `l2_pool` with SAME and VALID windows, against JAX."""
    from mvsnet_tpu.models import layers as jlayers
    from mvsnet_tpu_torch.models import layers

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    for relu, use_bias in ((True, True), (False, False)):
        jfc = jlayers.Fc(num_out=5, relu=relu, use_bias=use_bias)
        variables = jax.tree_util.tree_map(np.asarray,
                                           jfc.init(jax.random.PRNGKey(1), jnp.asarray(x)))
        if use_bias:
            variables["params"]["Dense_0"]["bias"] = rng.standard_normal(5).astype(np.float32)
        fc = layers.Fc(7 * 9 * 3, 5, relu=relu, use_bias=use_bias)
        fc.load_state_dict(state_dict_from_jax(variables))
        want = np.asarray(jfc.apply(variables, jnp.asarray(x)))
        np.testing.assert_allclose(fc(_t(x)).detach().numpy(), want, **NET)
    drop = layers.Dropout(0.25)
    np.testing.assert_array_equal(drop(_t(x)).numpy(), x)
    y = drop(_t(x), training=True).numpy()
    assert np.all((y == 0) | np.isclose(y, x / 0.75, rtol=1e-6))
    for size, stride, padding in ((2, 2, "SAME"), (3, 2, "SAME"), (3, 1, "SAME"),
                                  (2, 2, "VALID"), (3, 2, "VALID")):
        for name in ("max_pool", "avg_pool", "l2_pool"):
            want = np.asarray(getattr(jlayers, name)(jnp.asarray(x), size, stride, padding))
            got = getattr(layers, name)(_t(x), size, stride, padding).numpy()
            assert got.shape == want.shape, (name, size, stride, padding)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name} {size} {stride} {padding}")


def test_config_properties_native_flag_and_depth_dtypes():
    """`ModelConfig.base_divisor`, `feature_height`, `feature_width`;
    `native.has_native()`; the `dtype=` keyword of `depth_values` and
    `inv_depth_values`: against JAX."""
    from mvsnet_tpu import native as jnative
    from mvsnet_tpu.config import ModelConfig as JaxConfig
    from mvsnet_tpu_torch import native
    from mvsnet_tpu_torch.config import ModelConfig

    for mode in ("normal", "lite", "ultralite"):
        for w, h, scale in ((640, 512, 0.25), (1152, 864, 0.25), (330, 250, 0.5)):
            kw = dict(network_mode=mode, width=w, height=h, sample_scale=scale)
            a, b = JaxConfig(**kw), ModelConfig(**kw)
            assert (b.base_divisor, b.feature_height, b.feature_width) == (
                a.base_divisor, a.feature_height, a.feature_width)
    assert native.has_native() == jnative.has_native() is True
    ulp = {torch.float32: 2 ** -23, torch.float16: 2 ** -10, torch.bfloat16: 2 ** -7}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float16, torch.float16),
                     (jnp.bfloat16, torch.bfloat16)):
        for start, second in ((425.0, 2.5), (np.array([400.0, 510.0]), np.array([2.0, 1.25]))):
            want = np.asarray(jgeo.depth_values(start, second, 12, dtype=jdt).astype(jnp.float32))
            got = tgeo.depth_values(start, second, 12, dtype=tdt)
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.float().numpy(), want)
            end = np.asarray(start) + 300.0
            want = np.asarray(jgeo.inv_depth_values(start, end, 12, dtype=jdt)
                              .astype(jnp.float32))
            got = tgeo.inv_depth_values(start, end, 12, dtype=tdt)
            assert got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(), want, rtol=2 * ulp[tdt], atol=0)
