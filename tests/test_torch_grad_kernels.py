"""The port's backward kernels and conv gradients on the CPU, against the
JAX package on the same numpy inputs: the plain warp (K2) and transposed
warp (K3) against the Pallas kernels in interpret mode and against
`jax.vjp` of the XLA warp; the cost volume's gradients against `jax.vjp`
of the fused-cost custom VJP and of the XLA cost volume; the plain weight
gradient (K4w) against the Pallas weight-gradient kernels and XLA's; and
`ConvFn` / `DeconvFn` against `jax.vjp` of the JAX package's differentiable
convs, plus the adjoint identities that pin the transposed conv's kernel
orientation.

Tolerances: float32 on both sides with sums in another order. 1e-5
absolute and relative where a handful of products are summed (warps,
adjoints of one map), 1e-4 where hundreds to thousands are (weight
gradients, conv gradients, cost-volume gradients through the variance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsnet_tpu.ops.cost_volume import _warp_all_depths
from mvsnet_tpu.ops.cost_volume import plane_sweep_cost_volume as jax_cost_volume
from mvsnet_tpu.ops.pallas.conv2d import _xla_conv2d, _xla_conv2d_s2, rowconv2d, rowconv2d_s2
from mvsnet_tpu.ops.pallas.conv3d import _pallas_wgrad_s1, _pallas_wgrad_s2, rowconv3d
from mvsnet_tpu.ops.pallas.deconv2d import rowdeconv2d
from mvsnet_tpu.ops.pallas.deconv3d import _xla_deconv3d, rowdeconv3d
from mvsnet_tpu.ops.pallas.sweep import (_pallas_warp_transpose, pallas_sweep_cost_volume_ad,
                                         pallas_warp_all_depths)
from mvsnet_tpu_torch.ops import autograd
from mvsnet_tpu_torch.ops.cost_volume import plane_sweep_cost_volume
from mvsnet_tpu_torch.ops.kernels import deconv, warp, wgrad

TIGHT = dict(atol=1e-5, rtol=1e-5)
SUMS = dict(atol=1e-4, rtol=1e-4)


def _homs(D, scale=1.0, rot=0.02, shift=6.0):
    """Mild in-view homographies: shifts, a small rotation, a slight tilt."""
    c, s = np.cos(rot), np.sin(rot)
    h = np.zeros((D, 3, 3), np.float32)
    for d in range(D):
        t = d / max(D - 1, 1) - 0.5
        h[d] = [[scale * c, -s, shift * t], [s, scale * c, 0.4 * t], [1e-4, -5e-5, 1.0]]
    return h


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("scale,rot,shift", [(1.0, 0.02, 6.0), (1.3, -0.1, 15.0)])
def test_warp_plain_matches_pallas(scale, rot, shift):
    rng = np.random.default_rng(0)
    img, homs = _rand(rng, (16, 24, 8)), _homs(5, scale, rot, shift)
    want = pallas_warp_all_depths(jnp.asarray(img), jnp.asarray(homs), interpret=True)
    got = warp.warp_all_depths(_t(img), _t(homs))
    assert got.shape == (5, 16, 24, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("scale,rot,shift", [(1.0, 0.02, 6.0), (1.3, -0.1, 15.0)])
def test_warp_transpose_plain_matches_pallas_and_vjp(scale, rot, shift):
    rng = np.random.default_rng(1)
    img, homs, g = _rand(rng, (16, 24, 8)), _homs(5, scale, rot, shift), _rand(rng, (5, 16, 24, 8))
    got = warp.warp_transpose(_t(g), _t(homs)).numpy()
    pallas = _pallas_warp_transpose(jnp.asarray(g), jnp.asarray(homs), 16, 24, 8,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TIGHT)
    _, vjp = jax.vjp(lambda a: _warp_all_depths(a, jnp.asarray(homs), "zeros"),
                     jnp.asarray(img))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]), **TIGHT)


def test_warp_transpose_is_the_adjoint():
    """<warp(x), g> = <x, warp^T(g)>, with taps falling off the map."""
    rng = np.random.default_rng(2)
    x, g = _t(_rand(rng, (12, 16, 8))), _t(_rand(rng, (4, 12, 16, 8)))
    homs = _t(_homs(4, 1.5, 0.3, 20.0))
    lhs = (warp.warp_all_depths(x, homs).double() * g.double()).sum()
    rhs = (x.double() * warp.warp_transpose(g, homs).double()).sum()
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-5)


def _cost_inputs(rng, B=1, D=6, H=16, W=16, C=8):
    ref = _rand(rng, (B, H, W, C))
    views = _rand(rng, (2, B, H, W, C))
    homs = np.stack([np.stack([_homs(D, 1.0, 0.03, 5.0)] * B),
                     np.stack([_homs(D, 1.1, -0.05, -7.0)] * B)])
    g = _rand(rng, (B, D, H, W, C))
    return ref, views, homs, g


def _torch_cost_grads(ref, views, homs, g):
    r, v = _t(ref).requires_grad_(), _t(views).requires_grad_()
    out = plane_sweep_cost_volume(r, v, _t(homs), differentiable=True)
    out.backward(_t(g))
    return out.detach().numpy(), r.grad.numpy(), v.grad.numpy()


def test_cost_volume_grads_match_fused_vjp():
    rng = np.random.default_rng(3)
    ref, views, homs, g = _cost_inputs(rng)
    out, d_ref, d_views = _torch_cost_grads(ref, views, homs, g)
    want_out, vjp = jax.vjp(lambda r, v: pallas_sweep_cost_volume_ad(r, v, homs[:, 0], True),
                            jnp.asarray(ref[0]), jnp.asarray(views[:, 0]))
    want_ref, want_views = vjp(jnp.asarray(g[0]))
    np.testing.assert_allclose(out[0], np.asarray(want_out), **SUMS)
    np.testing.assert_allclose(d_ref[0], np.asarray(want_ref), **SUMS)
    np.testing.assert_allclose(d_views[:, 0], np.asarray(want_views), **SUMS)


def test_cost_volume_grads_match_xla_autodiff():
    """Batch of 2 through the XLA cost volume's own autodiff."""
    rng = np.random.default_rng(4)
    ref, views, homs, g = _cost_inputs(rng, B=2)
    out, d_ref, d_views = _torch_cost_grads(ref, views, homs, g)
    want_out, vjp = jax.vjp(
        lambda r, v: jax_cost_volume(r, v, jnp.asarray(homs), use_pallas=False,
                                     differentiable=True),
        jnp.asarray(ref), jnp.asarray(views))
    want_ref, want_views = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(want_out), **SUMS)
    np.testing.assert_allclose(d_ref, np.asarray(want_ref), **SUMS)
    np.testing.assert_allclose(d_views, np.asarray(want_views), **SUMS)


def _cw(a):
    """(B, D, H, W, C) -> the Pallas kernels' (B, D, H, C, W) layout."""
    return jnp.swapaxes(jnp.asarray(a), -1, -2)


@pytest.mark.parametrize("cin,cout", [(16, 8), (8, 1)])
def test_wgrad_plain_matches_pallas_s1(cin, cout):
    rng = np.random.default_rng(5)
    x, g = _rand(rng, (1, 4, 8, 16, cin)), _rand(rng, (1, 4, 8, 16, cout))
    want = _pallas_wgrad_s1(_cw(x), _cw(g), interpret=True)
    got = wgrad.wgrad(_t(x), _t(g), (3, 3, 3), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 8)])
def test_wgrad_plain_matches_pallas_s2(cin, cout):
    rng = np.random.default_rng(6)
    x, g = _rand(rng, (2, 4, 8, 16, cin)), _rand(rng, (2, 2, 4, 8, cout))
    want = _pallas_wgrad_s2(_cw(x), _cw(g), interpret=True)
    got = wgrad.wgrad(_t(x), _t(g), (3, 3, 3), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)


@pytest.mark.parametrize("K,stride,shape", [
    (3, 1, (2, 12, 20)), (3, 2, (2, 12, 20)), (5, 2, (2, 12, 20)), (5, 2, (1, 11, 13)),
    (3, 2, (1, 9, 7)),
])
def test_wgrad_plain_matches_xla_2d(K, stride, shape):
    rng = np.random.default_rng(7)
    x = _rand(rng, shape + (3,))
    k = _rand(rng, (K, K, 3, 8))
    conv = (lambda a, w: _xla_conv2d(a, w)) if stride == 1 else _xla_conv2d_s2
    y, vjp = jax.vjp(lambda w: conv(jnp.asarray(x), w), jnp.asarray(k))
    g = _rand(rng, y.shape)
    got = wgrad.wgrad(_t(x), _t(g), (K, K), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **SUMS)


def test_deconv_dk_matches_xla():
    """The transposed conv's dk: q of the stride-2 weight gradient with the
    roles of input and cotangent swapped (deconv3d.py:292-303)."""
    rng = np.random.default_rng(8)
    x, k = _rand(rng, (1, 2, 4, 6, 16)), _rand(rng, (3, 3, 3, 16, 8), 0.2)
    xt, kt = _t(x), _t(k).requires_grad_()
    y = autograd.DeconvFn.apply(xt, kt)
    g = _rand(rng, tuple(y.shape))
    y.backward(_t(g))
    _, vjp = jax.vjp(lambda w: _xla_deconv3d(jnp.asarray(x), w), jnp.asarray(k))
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **SUMS)


def _vjp_both(jax_fn, torch_fn, x, k, rng, x_grad=True):
    """(dx, dk) of the port's autograd function and of jax.vjp, for the
    same random cotangent."""
    y, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(k))
    g = _rand(rng, y.shape)
    want_dx, want_dk = vjp(jnp.asarray(g))
    xt, kt = _t(x).requires_grad_(x_grad), _t(k).requires_grad_()
    out = torch_fn(xt, kt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **SUMS)
    out.backward(_t(g))
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(want_dk), **SUMS)
    if x_grad:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **SUMS)
    else:
        assert xt.grad is None


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("MVSNET_TPU_FORCE_PALLAS_CONV", "1")


@pytest.mark.parametrize("stride,cin,cout", [(1, 16, 8), (2, 8, 16), (1, 8, 1)])
def test_conv3d_vjp_matches_jax(force_pallas, stride, cin, cout):
    rng = np.random.default_rng(9)
    x, k = _rand(rng, (1, 4, 8, 16, cin)), _rand(rng, (3, 3, 3, cin, cout), 0.1)
    _vjp_both(lambda a, w: rowconv3d(a, w, stride),
              lambda a, w: autograd.ConvFn.apply(a, w, stride), x, k, rng)


def test_deconv3d_vjp_matches_jax(force_pallas):
    rng = np.random.default_rng(10)
    x, k = _rand(rng, (1, 2, 4, 8, 16)), _rand(rng, (3, 3, 3, 16, 8), 0.1)
    _vjp_both(rowdeconv3d, autograd.DeconvFn.apply, x, k, rng)


@pytest.mark.parametrize("K,stride,cin,cout", [
    (3, 1, 8, 8), (3, 2, 8, 16), (5, 2, 8, 16), (3, 1, 16, 8),
])
def test_conv2d_vjp_matches_jax(force_pallas, K, stride, cin, cout):
    rng = np.random.default_rng(11)
    x, k = _rand(rng, (2, 16, 24, cin)), _rand(rng, (K, K, cin, cout), 0.1)
    _vjp_both(rowconv2d if stride == 1 else rowconv2d_s2,
              lambda a, w: autograd.ConvFn.apply(a, w, stride), x, k, rng)


def test_conv2d_vjp_without_input_grad(force_pallas):
    """The image convs: x needs no gradient, so dx is skipped."""
    rng = np.random.default_rng(12)
    x, k = _rand(rng, (2, 16, 24, 3)), _rand(rng, (3, 3, 3, 8), 0.1)
    _vjp_both(rowconv2d_s2, lambda a, w: autograd.ConvFn.apply(a, w, 2), x, k, rng, x_grad=False)


def test_deconv2d_vjp_matches_jax(force_pallas):
    rng = np.random.default_rng(13)
    x, k = _rand(rng, (2, 8, 12, 16)), _rand(rng, (3, 3, 16, 8), 0.1)
    _vjp_both(rowdeconv2d, autograd.DeconvFn.apply, x, k, rng)


@pytest.mark.parametrize("K,n", [(3, 16), (5, 16), (3, 15), (5, 15)])
def test_k5_adjoint_deconv_matches_xla_dx(K, n):
    """The stride-2 conv's dx as the transposed conv with the conv's low pad
    and the input's size, against jax.vjp of XLA's SAME stride-2 conv
    (conv2d.py:655-658), odd sizes included."""
    rng = np.random.default_rng(14)
    x, k = _rand(rng, (1, n, n + 2, 8)), _rand(rng, (K, K, 8, 16), 0.1)
    y, vjp = jax.vjp(lambda a: _xla_conv2d_s2(a, jnp.asarray(k)), jnp.asarray(x))
    g = _rand(rng, y.shape)
    got = autograd.conv_input_grad(_t(g), _t(k), 2, x.shape[1:3])
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **SUMS)


@pytest.mark.parametrize("rank", [2, 3])
def test_deconv_adjoint_identities(rank):
    """<deconv(x, k), g> = <x, dx> = <k, dk>: pins the q-transform of the
    role-swapped dk (deconv3d.py:302)."""
    rng = np.random.default_rng(15)
    shape = (1, 3, 4, 5) if rank == 3 else (2, 4, 5)
    x = _t(_rand(rng, shape + (8,))).double().float().requires_grad_()
    k = _t(_rand(rng, (3,) * rank + (8, 4), 0.2)).requires_grad_()
    y = autograd.DeconvFn.apply(x, k)
    g = _t(_rand(rng, tuple(y.shape)))
    y.backward(g)
    lhs = (y.detach().double() * g.double()).sum().item()
    np.testing.assert_allclose((x.detach().double() * x.grad.double()).sum().item(), lhs,
                               rtol=1e-5)
    np.testing.assert_allclose((k.detach().double() * k.grad.double()).sum().item(), lhs,
                               rtol=1e-5)


def test_deconv_rejects_bad_geometry():
    x, k = torch.zeros(1, 4, 4, 8), torch.zeros(5, 5, 8, 8)
    with pytest.raises(ValueError, match="does not fit"):
        deconv.deconv(x, k, lo=1, out_spatial=(12, 8))
    with pytest.raises(ValueError, match="3x3"):
        deconv.deconv(torch.zeros(1, 2, 4, 4, 8), torch.zeros(5, 5, 5, 8, 8))


@pytest.mark.parametrize("which", ["warp", "warp_transpose", "wgrad"])
def test_new_wrappers_never_fall_back_off_cpu(which):
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never reaches the plain version and never counts a launch."""
    m = torch.device("meta")
    before = (warp.launches, warp.transpose_launches, wgrad.launches)
    with pytest.raises(ValueError, match="CUDA"):
        if which == "warp":
            warp.warp_all_depths(torch.zeros(8, 8, 8, device=m), torch.zeros(2, 3, 3, device=m))
        elif which == "warp_transpose":
            warp.warp_transpose(torch.zeros(2, 8, 8, 8, device=m),
                                torch.zeros(2, 3, 3, device=m))
        else:
            wgrad.wgrad(torch.zeros(1, 8, 8, 4, device=m), torch.zeros(1, 8, 8, 8, device=m),
                        (3, 3), 1)
    assert (warp.launches, warp.transpose_launches, wgrad.launches) == before
