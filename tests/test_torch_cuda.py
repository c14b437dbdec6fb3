"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card, and a tiny forward on the card against the CPU.

This file imports no JAX (the card machine has none). Every test needs a
CUDA device and skips without one; run them on the card with

  python -m pytest --noconftest -o "markers=cuda: needs a CUDA device" \
      -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.ops.kernels import conv, deconv, sweep
from mvsnet_tpu_torch.predict import Predictor

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions are float32 references: no TF32 in cuDNN or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(rng, shape, dtype, dev, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32).to(dtype).to(dev)


def _homs(D, rot, shift, dev):
    h = np.tile(np.eye(3, dtype=np.float32), (D, 1, 1))
    c, s = np.cos(rot), np.sin(rot)
    for d in range(D):
        h[d] = [[c, -s, shift * (d / max(D - 1, 1) - 0.5)],
                [s, c, 0.3 * d], [1e-5, -5e-6, 1.0]]
    return torch.as_tensor(h, device=dev)


def _close(got, want, tol):
    """Max abs error within tol * max(1, max|want|): float32 sums in another
    order, and for bf16 one rounding of the output."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


# float32: order of sums only; bf16: plus one bf16 rounding (2^-8) of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_matches_plain(dev, dtype):
    rng = np.random.default_rng(0)
    H, W, C, D = 20, 28, 16, 6
    ref = _rand(rng, (H, W, C), dtype, dev)
    views = _rand(rng, (2, H, W, C), dtype, dev)
    homs = torch.stack([_homs(D, 0.02, 12.0, dev), _homs(D, -0.2, 30.0, dev)])
    before = sweep.launches
    got = sweep.cost_volume(ref, views, homs)
    assert sweep.launches == before + 1
    _close(got, sweep.cost_volume_plain(ref, views, homs), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,stride,cin,cout", [
    ((1, 6, 10, 12), 3, 1, 32, 8),
    ((1, 6, 10, 12), 3, 2, 16, 16),
    ((2, 5, 7, 9), 3, 2, 8, 1),
    ((1, 5, 7, 9), 3, 1, 4, 2),
    ((3, 16, 20), 3, 1, 3, 8),
    ((2, 16, 20), 3, 2, 24, 12),
    ((2, 15, 21), 5, 2, 8, 16),
    ((1, 8, 12), 3, 1, 128, 128),
])
def test_conv_matches_plain(dev, dtype, shape, k, stride, cin, cout):
    rng = np.random.default_rng(1)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), dtype, dev)
    w = _rand(rng, (k,) * rank + (cin, cout), dtype, dev, 0.2)
    b = _rand(rng, (cout,), torch.float32, dev)
    before = conv.launches
    for bias, relu in ((None, False), (b, True)):
        got = conv.conv(x, w, bias, stride, relu)
        _close(got, conv.conv_plain(x, w, bias, stride, relu), TOL[dtype])
    assert conv.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 3, 5, 6), 16, 8), ((2, 4, 3, 5), 8, 2), ((3, 6, 7), 64, 32),
    ((2, 5, 4), 3, 4),
])
def test_deconv_matches_plain(dev, dtype, shape, cin, cout):
    rng = np.random.default_rng(2)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), dtype, dev)
    w = _rand(rng, (3,) * rank + (cin, cout), dtype, dev, 0.2)
    b = _rand(rng, (cout,), torch.float32, dev)
    before = deconv.launches
    for bias, relu in ((None, False), (b, True)):
        got = deconv.deconv(x, w, bias, relu)
        _close(got, deconv.deconv_plain(x, w, bias, relu), TOL[dtype])
    assert deconv.launches == before + 2


def test_tiny_forward_card_matches_cpu(dev):
    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64,
                      network_mode="ultralite", compute_dtype="float32")
    rng = np.random.default_rng(3)
    images = rng.standard_normal((1, 3, 64, 64, 3)).astype(np.float32)
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = np.eye(4)
    cam[1, :3, :3] = [[15.0, 0, 8], [0, 15.0, 8], [0, 0, 1]]
    cams = np.stack([cam] * 3)[None].copy()
    cams[0, 1, 0, 0, 3] = 0.3
    cams[0, 2, 0, 1, 3] = -0.2
    args = (images, cams, np.array([5.0]), np.array([0.5]))
    d_gpu, p_gpu, _ = Predictor(cfg, seed=4, device=dev).predict(*args)
    d_cpu, p_cpu, _ = Predictor(cfg, seed=4, device="cpu").predict(*args)
    assert np.isfinite(d_gpu).all() and np.isfinite(p_gpu).all()
    # float32 end to end; sums in another order only
    np.testing.assert_allclose(d_gpu, d_cpu, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(p_gpu, p_cpu, atol=2e-3, rtol=1e-4)
