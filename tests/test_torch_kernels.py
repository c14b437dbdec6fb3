"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX package's Pallas kernel run in interpret mode, on the same numpy
inputs; and the wrappers' refusal to fall back for non-CPU tensors.

Tolerances: float32 on both sides, sums taken in another order, so 5e-5
absolute on outputs of order 1 (1e-4 for the cost volume, whose bilinear
weights come from coordinates of order 10).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvsnet_tpu.ops.pallas.conv2d import _rowconv2d_fwd_impl, _rowconv2d_s2_fwd_impl
from mvsnet_tpu.ops.pallas.conv3d import _rowconv3d_fwd_impl
from mvsnet_tpu.ops.pallas.deconv2d import _rowdeconv2d_fwd_impl
from mvsnet_tpu.ops.pallas.deconv3d import _rowdeconv3d_fwd_impl
from mvsnet_tpu.ops.pallas.sweep import pallas_sweep_cost_volume
from mvsnet_tpu_torch.ops.kernels import _lib, conv, deconv, sweep

ATOL, RTOL = 5e-5, 1e-5


def _inputs(seed, x_shape, k_shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    k = (rng.standard_normal(k_shape) * 0.1).astype(np.float32)
    b = rng.standard_normal(k_shape[-1]).astype(np.float32)
    return x, k, b


def _homs(D, scale=1.0, rot=0.02, shift_range=12.0):
    h = np.tile(np.eye(3, dtype=np.float32), (D, 1, 1))
    c, s = np.cos(rot), np.sin(rot)
    for d in range(D):
        h[d] = [[scale * c, -s, shift_range * (d / max(D - 1, 1) - 0.5)],
                [s, scale * c, 0.3 * d / max(D - 1, 1)],
                [1e-5, -5e-6, 1.0]]
    return h


@pytest.mark.parametrize("homs", [
    "shift",       # in-view shifts and a small rotation
    "zoom",        # zoomed out and rotated: many taps fall outside the map
])
def test_cost_volume_plain_matches_pallas(homs):
    rng = np.random.default_rng(3)
    H, W, C, D = 16, 24, 8, 5
    ref = rng.standard_normal((H, W, C)).astype(np.float32)
    views = rng.standard_normal((2, H, W, C)).astype(np.float32)
    if homs == "shift":
        hs = np.stack([_homs(D), _homs(D, rot=-0.03, shift_range=8.0)])
    else:
        hs = np.stack([_homs(D, scale=1.8, rot=0.25, shift_range=30.0),
                       _homs(D, rot=-0.05)])
    want = np.asarray(pallas_sweep_cost_volume(jnp.asarray(ref), jnp.asarray(views),
                                               jnp.asarray(hs), interpret=True))
    got = sweep.cost_volume(torch.from_numpy(ref), torch.from_numpy(views),
                            torch.from_numpy(hs))
    assert got.shape == (D, H, W, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cin,cout,stride", [
    (32, 8, 1),    # 3dconv0_1 at the operating point: 32 -> 8
    (8, 8, 1),
    (16, 16, 2),   # stride-2 encoder convs
    (8, 1, 1),     # 3dconv6_2: one output channel
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_conv3d_plain_matches_pallas(cin, cout, stride, epilogue):
    x, k, b = _inputs(0, (1, 4, 8, 16, cin), (3, 3, 3, cin, cout))
    bias = b if epilogue else None
    want = _rowconv3d_fwd_impl(jnp.asarray(x), jnp.asarray(k),
                               None if bias is None else jnp.asarray(bias),
                               stride=stride, relu=epilogue, interpret=True)
    got = conv.conv(torch.from_numpy(x), torch.from_numpy(k),
                    None if bias is None else torch.from_numpy(bias), stride, epilogue)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cin,cout,stride,K", [
    (32, 8, 1, 3),
    (8, 8, 1, 3),
    (3, 8, 1, 3),     # 2dconv0_1: the image's three channels
    (3, 16, 2, 3),    # 2dconv1_0
    (16, 16, 2, 3),
    (8, 16, 2, 5),    # conv9_0: 5x5 stride 2
])
def test_conv2d_plain_matches_pallas(cin, cout, stride, K):
    x, k, b = _inputs(6, (2, 16, 32, cin), (K, K, cin, cout))
    impl = _rowconv2d_s2_fwd_impl if stride == 2 else _rowconv2d_fwd_impl
    for bias, relu in ((None, False), (b, True)):
        want = impl(jnp.asarray(x), jnp.asarray(k),
                    None if bias is None else jnp.asarray(bias), relu=relu,
                    interpret=True)
        got = conv.conv(torch.from_numpy(x), torch.from_numpy(k),
                        None if bias is None else torch.from_numpy(bias), stride, relu)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,k,s,want", [
    (64, 3, 1, (1, 1, 64)), (64, 3, 2, (0, 1, 32)), (64, 5, 2, (1, 2, 32)),
    (63, 3, 2, (1, 1, 32)), (8, 5, 2, (1, 2, 4)),
])
def test_same_pads_follow_tf(n, k, s, want):
    """Low pad total // 2: stride-2 pads are (0, 1) for K=3 and (1, 2) for
    K=5 on even inputs, where torch's symmetric padding=K//2 differs."""
    assert conv.same_pads(n, k, s) == want


@pytest.mark.parametrize("rank,cin,cout", [(3, 16, 8), (3, 64, 32), (2, 16, 8),
                                           (2, 128, 64)])
def test_deconv_plain_matches_pallas(rank, cin, cout):
    shape = (1, 3, 8, 16) if rank == 3 else (1, 8, 16)
    x, k, b = _inputs(1, shape + (cin,), (3,) * rank + (cin, cout))
    impl = _rowdeconv3d_fwd_impl if rank == 3 else _rowdeconv2d_fwd_impl
    for bias, relu in ((None, False), (b, True)):
        want = impl(jnp.asarray(x), jnp.asarray(k),
                    None if bias is None else jnp.asarray(bias), relu=relu,
                    interpret=True)
        got = deconv.deconv(torch.from_numpy(x), torch.from_numpy(k),
                            None if bias is None else torch.from_numpy(bias), relu)
        assert got.shape == (1,) + tuple(2 * n for n in shape[1:]) + (cout,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("which", ["cost_volume", "conv", "deconv"])
def test_wrappers_never_fall_back_off_cpu(which):
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never reaches the plain version and never counts a launch."""
    m = torch.device("meta")
    mod = {"cost_volume": sweep, "conv": conv, "deconv": deconv}[which]
    before = mod.launches
    with pytest.raises(ValueError, match="CUDA"):
        if which == "cost_volume":
            sweep.cost_volume(torch.zeros(8, 8, 8, device=m),
                              torch.zeros(1, 8, 8, 8, device=m),
                              torch.zeros(1, 2, 3, 3, device=m))
        elif which == "conv":
            conv.conv(torch.zeros(1, 8, 8, 4, device=m), torch.zeros(3, 3, 4, 8, device=m))
        else:
            deconv.deconv(torch.zeros(1, 4, 4, 4, device=m),
                          torch.zeros(3, 3, 4, 8, device=m))
    assert mod.launches == before


@pytest.mark.parametrize("which", ["conv", "deconv"])
def test_wrappers_reject_mismatched_bias(which):
    """A bias that does not have one entry per output channel is refused
    before any pointer is passed to a kernel."""
    x, k = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError, match="output channels"):
        if which == "conv":
            conv.conv(x, k, torch.zeros(4))
        else:
            deconv.deconv(x, k, torch.zeros(4))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel that does not build raises with the compiler's output."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_lib, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such target"):
        _lib.build_all(("conv",))
    assert not list((tmp_path / "build").glob("*.so"))
