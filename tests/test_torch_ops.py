"""The port's geometry, warp, cost volume and depth tail against the JAX
package on the CPU, on the same numpy inputs.

Tolerances: float32 on both sides. Homographies and coordinates come from
small matmuls taken in another order (relative 1e-5; coordinates of order
100 px, so 1e-4 absolute); sampling and the depth tail are elementwise or
short sums (1e-5 absolute).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvsnet_tpu.ops import cost_volume as jcv
from mvsnet_tpu.ops import depth as jdepth
from mvsnet_tpu.ops import geometry as jgeo
from mvsnet_tpu.ops import warp as jwarp
from mvsnet_tpu_torch.ops import cost_volume as tcv
from mvsnet_tpu_torch.ops import depth as tdepth
from mvsnet_tpu_torch.ops import geometry as tgeo
from mvsnet_tpu_torch.ops import warp as twarp


def _rot(rng):
    a = rng.standard_normal(3) * 0.1
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + K + K @ K / 2          # near-rotation, well conditioned


def _cams(rng, B=2, V=3, W=24.0, H=16.0):
    cams = np.zeros((B, V, 2, 4, 4), np.float32)
    for b in range(B):
        for v in range(V):
            cams[b, v, 0, :3, :3] = _rot(rng)
            cams[b, v, 0, :3, 3] = rng.standard_normal(3) * [2.0, 1.0, 0.5]
            cams[b, v, 0, 3, 3] = 1.0
            f = 20.0 + 5 * rng.random()
            cams[b, v, 1, :3, :3] = [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]
    return cams


@pytest.mark.parametrize("batched", [False, True])
def test_depth_values(batched):
    start = np.array([5.0, 2.5], np.float32) if batched else np.float32(5.0)
    interval = np.array([0.5, -0.25], np.float32) if batched else np.float32(0.5)
    end = np.array([9.0, 7.0], np.float32) if batched else np.float32(9.0)
    np.testing.assert_allclose(tgeo.depth_values(start, interval, 8).numpy(),
                               np.asarray(jgeo.depth_values(start, interval, 8)),
                               rtol=1e-6)
    np.testing.assert_allclose(tgeo.inv_depth_values(start, end, 8).numpy(),
                               np.asarray(jgeo.inv_depth_values(start, end, 8)),
                               rtol=1e-6)


@pytest.mark.parametrize("inverse_depth", [False, True])
def test_homographies_for_views(inverse_depth):
    rng = np.random.default_rng(0)
    cams = _cams(rng)
    ds = np.array([5.0, 4.0], np.float32)
    di = np.array([0.5, 0.25], np.float32)
    de = ds + 7 * di
    want = jgeo.homographies_for_views(jnp.asarray(cams), 8, ds, di, de,
                                       inverse_depth=inverse_depth)
    got = tgeo.homographies_for_views(torch.from_numpy(cams), 8, torch.from_numpy(ds),
                                      torch.from_numpy(di), torch.from_numpy(de),
                                      inverse_depth=inverse_depth)
    assert got.shape == (2, 2, 8, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_projected_coords_and_guard():
    rng = np.random.default_rng(1)
    homs = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    homs[:3] += rng.standard_normal((3, 3, 3)).astype(np.float32) * 0.05
    homs[3, 2] = [0.0, 0.0, 0.0]             # w == 0: the |w| < 1e-7 guard
    want = jwarp.projected_coords(jnp.asarray(homs), 16, 24)
    got = twarp.projected_coords(torch.from_numpy(homs), 16, 24)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:3].numpy(), np.asarray(w)[:3], atol=1e-4, rtol=1e-5)
        np.testing.assert_array_equal(g[3].numpy(), np.asarray(w)[3])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_bilinear_sample_zero_fill(dtype):
    """Taps at integer positions, off the map on every side, and inside."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((16, 24, 8)).astype(np.float32)
    x = np.concatenate([rng.uniform(-3, 27, 200), np.arange(-2, 26, 1.0),
                        [-1.0, -0.5, 23.0, 23.5]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-3, 19, 200), np.arange(-2, 26, 1.0) % 18 - 1,
                        [0.0, -0.5, 15.0, 15.5]]).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jwarp.bilinear_sample(jnp.asarray(img, jd), jnp.asarray(x), jnp.asarray(y))
    got = twarp.bilinear_sample(torch.from_numpy(img).to(td), torch.from_numpy(x),
                                torch.from_numpy(y))
    tol = 1e-6 if dtype == np.float32 else 2e-2     # bf16 blend: 2^-8 relative
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("chunks", [1, 3])
def test_plane_sweep_cost_volume(monkeypatch, chunks):
    """Batched cost volume against the JAX XLA path; with chunks=3 the CPU
    path splits depth as it does above 2 GiB of float32 sums."""
    rng = np.random.default_rng(4)
    B, H, W, C, D = 2, 16, 24, 8, 6
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    views = rng.standard_normal((2, B, H, W, C)).astype(np.float32)
    cams = _cams(rng, B=B)
    homs = np.array(jgeo.homographies_for_views(
        jnp.asarray(cams), D, np.array([5.0, 4.0]), np.array([0.5, 0.25])))
    if chunks > 1:
        monkeypatch.setattr(tcv, "ACC_LIMIT_BYTES", H * W * C * 4 * D // chunks)
    want = jcv.plane_sweep_cost_volume(jnp.asarray(ref), jnp.asarray(views),
                                       jnp.asarray(homs), use_pallas=False)
    got = tcv.plane_sweep_cost_volume(torch.from_numpy(ref), torch.from_numpy(views),
                                      torch.from_numpy(homs))
    assert got.shape == (B, D, H, W, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _reg(seed, B=2, D=8, H=6, W=7):
    return (np.random.default_rng(seed).standard_normal((B, D, H, W)) * 3).astype(np.float32)


@pytest.mark.parametrize("buckets", [2, 4])
@pytest.mark.parametrize("inverse_depth", [False, True])
def test_soft_argmin_prob_map(buckets, inverse_depth):
    reg = _reg(5)
    ds, di = np.array([5.0, 4.0], np.float32), np.array([0.5, 0.25], np.float32)
    de = ds + 7 * di
    want = jdepth.soft_argmin_prob_map(jnp.asarray(reg), ds, di, 8, inverse_depth,
                                       de, buckets)
    got = tdepth.soft_argmin_prob_map(torch.from_numpy(reg), torch.from_numpy(ds),
                                      torch.from_numpy(di), 8, inverse_depth,
                                      torch.from_numpy(de), buckets)
    for g, w in zip(got, want):
        assert g.shape == (2, 6, 7, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("buckets", [2, 4])
@pytest.mark.parametrize("inverse_depth", [False, True])
def test_soft_argmin_then_probability_map(buckets, inverse_depth):
    reg = _reg(6)
    ds, di = np.array([5.0, 4.0], np.float32), np.array([0.5, 0.25], np.float32)
    de = ds + 7 * di
    jd, jp = jdepth.soft_argmin(jnp.asarray(reg), ds, di, 8, inverse_depth, de)
    td, tp = tdepth.soft_argmin(torch.from_numpy(reg), torch.from_numpy(ds),
                                torch.from_numpy(di), 8, inverse_depth,
                                torch.from_numpy(de))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    want = jdepth.probability_map(jp, jd, ds, di, inverse_depth, buckets)
    got = tdepth.probability_map(tp, td, torch.from_numpy(ds), torch.from_numpy(di),
                                 inverse_depth, buckets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
