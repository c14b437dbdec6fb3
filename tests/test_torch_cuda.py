"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card, the adjoint identities of the backward kernels, and a
tiny forward and train step on the card against the CPU.

This file imports no JAX (the card machine has none). Every test needs a
CUDA device and skips without one; run them on the card with

  python -m pytest --noconftest -o "markers=cuda: needs a CUDA device" \
      -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mvsnet_tpu_torch import train_lib
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from mvsnet_tpu_torch.models import MVSNet
from mvsnet_tpu_torch.ops import autograd
from mvsnet_tpu_torch.ops.cost_volume import cost_volume_backward
from mvsnet_tpu_torch.ops.kernels import conv, deconv, sweep, warp, wgrad
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
@pytest.mark.parametrize("depth,space", [(2, 2), (3, 1), (1, 4)])
def test_sharded_cost_volume_blocks_stitch_to_k1(dev, dtype, depth, space):
    """K1s on every (depth slab, row block) of a (depth, space) mesh,
    stitched, is K1 bit for bit: each element is the same arithmetic on the
    same inputs, so any difference is a wrong row or bound."""
    rng = np.random.default_rng(1)
    H, W, C, D = 20, 28, 16, 6
    ref = _rand(rng, (H, W, C), dtype, dev)
    views = _rand(rng, (2, H, W, C), dtype, dev)
    homs = torch.stack([_homs(D, 0.02, 12.0, dev), _homs(D, -0.2, 30.0, dev)])
    whole = sweep.cost_volume(ref, views, homs)
    Dl, Hl = D // depth, H // space
    before = (sweep.launches, sweep.launches_sharded)
    stitched = torch.cat([
        torch.cat([sweep.cost_volume(ref[s * Hl:(s + 1) * Hl], views,
                                     homs[:, d * Dl:(d + 1) * Dl], row_offset=s * Hl)
                   for s in range(space)], dim=1)
        for d in range(depth)], dim=0)
    assert (sweep.launches, sweep.launches_sharded) == (before[0],
                                                        before[1] + depth * space)
    assert torch.equal(stitched, whole)
    block = sweep.cost_volume(ref[Hl:2 * Hl] if space > 1 else ref, views, homs[:, :Dl],
                              row_offset=Hl if space > 1 else 0)
    _close(block, sweep.cost_volume_plain(ref[Hl:2 * Hl] if space > 1 else ref, views,
                                          homs[:, :Dl], Hl if space > 1 else 0), TOL[dtype])


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
    args = (images, cams, np.array([5.0]), np.array([0.5]), np.array([8.5]))
    d_gpu, p_gpu, _ = Predictor(cfg, seed=4, device=dev).predict(*args)
    d_cpu, p_cpu, _ = Predictor(cfg, seed=4, device="cpu").predict(*args)
    assert np.isfinite(d_gpu).all() and np.isfinite(p_gpu).all()
    # float32 end to end; sums in another order only
    np.testing.assert_allclose(d_gpu, d_cpu, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(p_gpu, p_cpu, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_matches_plain(dev, dtype):
    rng = np.random.default_rng(5)
    img = _rand(rng, (20, 28, 16), dtype, dev)
    for homs in (_homs(6, 0.02, 12.0, dev), _homs(6, -0.2, 30.0, dev)):
        before = warp.launches
        got = warp.warp_all_depths(img, homs)
        assert warp.launches == before + 1
        _close(got, warp.warp_all_depths_plain(img, homs), TOL[dtype])


def test_warp_samples_as_the_cost_volume(dev):
    """K1 and K2 share their taps (csrc/common.cuh): with one source view
    and a zero reference, K1's variance is w^2 / 4 of K2's warp w, to float32
    rounding of the variance arithmetic."""
    rng = np.random.default_rng(13)
    img = _rand(rng, (20, 28, 16), torch.float32, dev)
    homs = _homs(6, -0.2, 30.0, dev)
    cost = sweep.cost_volume(torch.zeros_like(img), img[None], homs[None])
    w = warp.warp_all_depths(img, homs)
    _close(cost, w * w / 4, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_transpose_matches_plain(dev, dtype):
    """Float32 output either way: the gather sums in another order than the
    plain version's index_add_, at float32 precision."""
    rng = np.random.default_rng(6)
    g = _rand(rng, (40, 20, 28, 16), dtype, dev)
    for homs in (_homs(40, 0.02, 12.0, dev), _homs(40, -0.2, 30.0, dev)):
        before = warp.transpose_launches
        got = warp.warp_transpose(g, homs)
        assert warp.transpose_launches == before + 1 and got.dtype == torch.float32
        _close(got, warp.warp_transpose_plain(g, homs), TOL[torch.float32])


def _degenerate_homs(D, dev):
    """Ordinary planes with, among them, one whose every tap falls outside
    the map, one whose horizon (w = 0) crosses it, one with w < 0 over all
    of it, and one whose horizon lies just off its right edge."""
    h = _homs(D, -0.2, 30.0, dev).cpu().numpy()
    h[1, :2, 2] = [1000.0, -700.0]
    h[2] = [[1.0, 0.05, 0.0], [0.0, 1.0, 0.0], [0.1, 0.0, -1.0]]
    h[3] = -np.eye(3, dtype=np.float32)
    h[4] = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-0.035, 0.0, 1.0]]
    return torch.as_tensor(h, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_transpose_matches_plain_on_degenerate_planes(dev, dtype):
    rng = np.random.default_rng(8)
    g = _rand(rng, (8, 20, 28, 16), dtype, dev)
    homs = _degenerate_homs(8, dev)
    assert warp.transpose_plan(homs, 20, 28)[1].tolist() == [1, 1, 0, -1, 1, 1, 1, 1]
    _close(warp.warp_transpose(g, homs), warp.warp_transpose_plain(g, homs), TOL[torch.float32])


def test_transpose_plan_kernel_matches_cpu(dev):
    """K3's plan kernel against `transpose_plan`'s float64 PyTorch on the
    CPU: the inverses to float32 rounding, the signs exactly."""
    homs = torch.cat([_degenerate_homs(8, dev), _homs(192, 0.02, 12.0, dev)])
    inv, wsign = warp.transpose_plan(homs, 120, 160)
    inv_cpu, wsign_cpu = warp.transpose_plan(homs.cpu(), 120, 160)
    assert torch.equal(wsign.cpu(), wsign_cpu)
    ok = wsign_cpu != 0
    torch.testing.assert_close(inv.cpu()[ok], inv_cpu[ok], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_transpose_is_deterministic(dev, dtype):
    """Each output element is summed by one thread in a fixed order: two
    calls are equal bit for bit, at the training point's shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((192, 120, 160, 32), generator=gen, device=dev).to(dtype)
    homs = _homs(192, 0.02, 12.0, dev)
    a, b = warp.warp_transpose(g, homs), warp.warp_transpose(g, homs)
    assert torch.equal(a, b)


def test_cost_volume_backward_is_deterministic(dev):
    """The cost volume's backward (K2, PyTorch's elementwise chain, K3) at
    the training point in bf16: two calls are equal bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ref, views = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                  for s in ((120, 160, 32), (2, 120, 160, 32)))
    g = torch.randn((192, 120, 160, 32), generator=gen, device=dev).to(torch.bfloat16)
    homs = torch.stack([_homs(192, 0.02, 12.0, dev), _homs(192, -0.05, 20.0, dev)])
    first, second = cost_volume_backward(ref, views, homs, g), cost_volume_backward(
        ref, views, homs, g)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("D", [16, 13])
def test_cost_volume_backward_in_depth_chunks_on_card(dev, D, monkeypatch):
    """The cost volume's backward in three depth chunks (the 2 GiB limit
    lowered to a third of this volume's float32 sums), whose homographies
    start at a plane that is not a multiple of 4, and at a D that is not
    one (the second view's planes start off 16 bytes): the kernels take
    each chunk, and the result matches the plain version's on the CPU."""
    from mvsnet_tpu_torch.ops import cost_volume

    rng = np.random.default_rng(40 + D)
    ref, views = (_rand(rng, s, torch.float32, dev) for s in ((24, 40, 32), (2, 24, 40, 32)))
    g = _rand(rng, (D, 24, 40, 32), torch.float32, dev)
    homs = torch.stack([_homs(D, 0.02, 3.0, dev), _homs(D, -0.05, 5.0, dev)])
    monkeypatch.setattr(cost_volume, "ACC_LIMIT_BYTES", -(-3 * g.numel() * 4 // 3))
    before = (warp.launches, warp.transpose_launches)
    got = cost_volume_backward(ref, views, homs, g)
    assert (warp.launches, warp.transpose_launches) == (before[0] + 6, before[1] + 6)
    want = cost_volume_backward(*(t.cpu() for t in (ref, views, homs, g)))
    for a, b in zip(got, want):
        _close(a.cpu(), b, TOL[torch.float32])


def test_warp_transpose_is_the_adjoint_on_card(dev):
    rng = np.random.default_rng(7)
    x = _rand(rng, (20, 28, 16), torch.float32, dev)
    g = _rand(rng, (12, 20, 28, 16), torch.float32, dev)
    homs = _homs(12, -0.2, 30.0, dev)
    lhs = (warp.warp_all_depths(x, homs).double() * g.double()).sum().item()
    rhs = (x.double() * warp.warp_transpose(g, homs).double()).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,stride,cin,cout", [
    ((1, 6, 10, 12), 3, 1, 32, 8),
    ((1, 6, 10, 12), 3, 2, 16, 16),
    ((2, 5, 7, 9), 3, 2, 8, 1),
    ((3, 16, 20), 3, 1, 3, 8),
    ((2, 15, 21), 5, 2, 8, 16),
    ((1, 8, 12), 3, 1, 128, 128),
])
def test_wgrad_matches_plain(dev, dtype, shape, k, stride, cin, cout):
    """Float32 sums on both sides; for bf16 the inputs are the same rounded
    values, so the tolerance is float32's."""
    rng = np.random.default_rng(8)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), dtype, dev)
    out = [conv.same_pads(n, k, stride)[2] for n in shape[1:]]
    g = _rand(rng, (shape[0], *out, cout), dtype, dev)
    before = wgrad.launches
    got = wgrad.wgrad(x, g, (k,) * rank, stride)
    assert wgrad.launches == before + 1
    _close(got, wgrad.wgrad_plain(x, g, (k,) * rank, stride), TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 15])
def test_k5_adjoint_deconv_matches_plain(dev, dtype, n):
    rng = np.random.default_rng(9)
    g = _rand(rng, (2, (n + 1) // 2, (n + 3) // 2, 16), dtype, dev)
    k = _rand(rng, (5, 5, 16, 8), dtype, dev, 0.2)
    lo = conv.same_pads(n, 5, 2)[0]
    before = deconv.launches
    got = deconv.deconv(g, k, lo=lo, out_spatial=(n, n + 2))
    assert deconv.launches == before + 1
    _close(got, deconv.deconv_plain(g, k, lo=lo, out_spatial=(n, n + 2)), TOL[dtype])


@pytest.mark.parametrize("rank,stride", [(3, 1), (3, 2), (2, 2), (2, 1)])
def test_conv_adjoint_identities_on_card(dev, rank, stride):
    """<conv(x, k), g> = <x, dx> = <k, dk> through ConvFn's kernels."""
    rng = np.random.default_rng(10)
    shape = (1, 4, 6, 8) if rank == 3 else (2, 10, 12)
    K = 5 if (rank, stride) == (2, 2) else 3
    x = _rand(rng, shape + (8,), torch.float32, dev).requires_grad_()
    k = _rand(rng, (K,) * rank + (8, 16), torch.float32, dev, 0.2).requires_grad_()
    y = autograd.ConvFn.apply(x, k, stride)
    g = torch.randn_like(y)
    y.backward(g)
    lhs = (y.detach().double() * g.double()).sum().item()
    for a in (x, k):
        rhs = (a.detach().double() * a.grad.double()).sum().item()
        assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))


@pytest.mark.parametrize("rank", [3, 2])
def test_deconv_adjoint_identities_on_card(dev, rank):
    rng = np.random.default_rng(11)
    shape = (1, 3, 4, 5) if rank == 3 else (2, 4, 5)
    x = _rand(rng, shape + (16,), torch.float32, dev).requires_grad_()
    k = _rand(rng, (3,) * rank + (16, 8), torch.float32, dev, 0.2).requires_grad_()
    y = autograd.DeconvFn.apply(x, k)
    g = torch.randn_like(y)
    y.backward(g)
    lhs = (y.detach().double() * g.double()).sum().item()
    for a in (x, k):
        rhs = (a.detach().double() * a.grad.double()).sum().item()
        assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))


def _perturb_norms(model, seed):
    """Non-identity norms: with the identity init some gradient leaves are
    sums of terms that nearly cancel, and rounding alone moves them by
    several 1e-3 of their largest entry (float64 convs against float32 on
    the CPU), against under 1e-4 with these."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith(("scale", "var")):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith((".gn.bias", ".bn.bias", "mean")):
                t.copy_(0.2 * torch.randn(t.shape, generator=g))


def test_tiny_train_step_card_matches_cpu(dev):
    """One float32 step of the normal-width graph at 64x64, D=8, with
    non-identity norms: the loss to 1e-4; the gradients to 5e-3 in the
    norm of all leaves and to 2e-2 of each leaf's largest entry. The
    gradients are sensitive to rounding: at this size the CPU's float32
    convs differ from float64 ones by 6e-4 globally and 3e-3 in the worst
    leaf, and the card, which lands within 8e-5 of the float64 answer,
    differs from the CPU by as much."""
    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64,
                      network_mode="normal", compute_dtype="float32")
    tcfg = TrainConfig()
    rng = np.random.default_rng(12)
    images = rng.standard_normal((1, 3, 64, 64, 3)).astype(np.float32)
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = np.eye(4)
    cam[1, :3, :3] = [[15.0, 0, 8], [0, 15.0, 8], [0, 0, 1]]
    cam[1, 3] = [5.0, 0.5, 8, 8.5]
    cams = np.stack([cam] * 3)[None].copy()
    cams[0, 1, 0, 0, 3] = 0.3
    cams[0, 2, 0, 1, 3] = -0.2
    gt = rng.uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    batch = (images, cams, gt, gt)
    models = []
    for device in (dev, "cpu"):
        model = MVSNet(cfg, seed=5)
        _perturb_norms(model, 6)
        state = train_lib.create_train_state(model, cfg, tcfg, device=device)
        _, metrics = train_lib.make_train_step(model, cfg, tcfg)(state, batch)
        models.append((model, metrics))
    (m_gpu, met_gpu), (m_cpu, met_cpu) = models
    assert abs(met_gpu["loss"].item() - met_cpu["loss"].item()) <= 1e-4 * abs(met_cpu["loss"].item())
    cpu_params = dict(m_cpu.named_parameters())
    num = den = 0.0
    for name, p in m_gpu.named_parameters():
        want, got = cpu_params[name].grad, p.grad.cpu()
        assert torch.isfinite(got).all(), name
        assert (got - want).abs().max() <= 2e-2 * max(want.abs().max().item(), 1e-12), name
        num, den = num + ((got - want) ** 2).sum().item(), den + (want ** 2).sum().item()
    assert (num / den) ** 0.5 <= 5e-3


def _editions():
    return {"conv": dict(conv.launches_by_edition), "deconv": dict(deconv.launches_by_edition),
            "wgrad": dict(wgrad.launches_by_edition)}


@pytest.mark.parametrize("shape,k,stride,cin,cout,pads", [
    ((1, 6, 9, 11), 3, 1, 8, 1, None),                  # Cout = 1 (3dconv6_2)
    ((2, 17, 19), 3, 1, 8, 8, None),                    # Cin = 8: two taps a k step
    ((1, 5, 7, 9), 3, 1, 8, 16, None),
    ((1, 5, 6, 7), 3, 1, 64, 64, None),                 # weights streamed (3dconv3_1)
    ((1, 7, 9), 3, 1, 128, 128, None),                  # weights streamed (2dconv4_1)
    ((1, 7, 9, 11), 3, 2, 16, 16, None),                # stride 2, odd sizes
    ((2, 15, 17), 3, 2, 32, 64, None),
    ((2, 15, 21), 5, 2, 8, 16, None),                   # 5x5 stride 2 (conv9_0), odd
    ((1, 8, 9, 11), 3, 1, 16, 32, [(0, 0), (1, 1), (1, 1)]),   # halo_conv's pads
    ((1, 9, 9, 11), 3, 2, 32, 16, [(0, 0), (0, 1), (1, 1)]),
])
def test_conv_tc_matches_plain(dev, shape, k, stride, cin, cout, pads):
    rng = np.random.default_rng(14)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), torch.bfloat16, dev)
    w = _rand(rng, (k,) * rank + (cin, cout), torch.bfloat16, dev, (k ** rank * cin) ** -0.5)
    b = _rand(rng, (cout,), torch.float32, dev)
    before = _editions()["conv"]
    for bias, relu in ((None, False), (b, True)):
        got = conv.conv(x, w, bias, stride, relu, pads, edition="tc")
        _close(got, conv.conv_plain(x, w, bias, stride, relu, pads), TOL[torch.bfloat16])
    assert _editions()["conv"] == {"tc": before["tc"] + 2, "simt": before["simt"]}


@pytest.mark.parametrize("shape,k,cin,cout,lo,outs", [
    ((1, 3, 5, 7), 3, 16, 8, 0, None),                  # 3D, odd input sizes
    ((1, 5, 3, 3), 3, 64, 32, 0, None),                 # 3dconv4_0's channels
    ((2, 4, 4, 5), 3, 8, 8, (2, 0, 0), (6, 8, 10)),     # halo_deconv's lo
    ((3, 5, 7), 3, 32, 16, 0, None),                    # 2D
    ((3, 240, 320), 5, 16, 8, 1, (480, 640)),           # conv9_0's dx at 480x640
    ((2, 8, 11), 5, 16, 8, 1, (15, 21)),                # the K = 5 adjoint, odd sizes
    ((2, 8, 11), 5, 16, 8, 2, (16, 21)),
])
def test_deconv_tc_matches_plain(dev, shape, k, cin, cout, lo, outs):
    rng = np.random.default_rng(15)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), torch.bfloat16, dev)
    w = _rand(rng, (k,) * rank + (cin, cout), torch.bfloat16, dev, (k * k * cin) ** -0.5)
    b = _rand(rng, (cout,), torch.float32, dev)
    before = _editions()["deconv"]
    for bias, relu in ((None, False), (b, True)):
        got = deconv.deconv(x, w, bias, relu, lo, outs, edition="tc")
        _close(got, deconv.deconv_plain(x, w, bias, relu, lo, outs), TOL[torch.bfloat16])
    assert _editions()["deconv"] == {"tc": before["tc"] + 2, "simt": before["simt"]}


def test_edition_rule_on_card(dev):
    """bf16 runs "tc" by default at any Cin (8 and 3 here); float32 runs
    "simt", and asking for "tc" on it raises before any launch."""
    rng = np.random.default_rng(16)
    w8 = _rand(rng, (3, 3, 8, 8), torch.bfloat16, dev)
    before = _editions()
    conv.conv(_rand(rng, (1, 9, 10, 8), torch.bfloat16, dev), w8)
    conv.conv(_rand(rng, (1, 9, 10, 3), torch.bfloat16, dev), w8[:, :, :3])
    conv.conv(_rand(rng, (1, 9, 10, 8), torch.float32, dev), w8.float())
    deconv.deconv(_rand(rng, (1, 4, 5, 8), torch.bfloat16, dev), w8)
    deconv.deconv(_rand(rng, (1, 4, 5, 3), torch.bfloat16, dev), w8[:, :, :3])
    after = _editions()
    assert after["conv"] == {"tc": before["conv"]["tc"] + 2, "simt": before["conv"]["simt"] + 1}
    assert after["deconv"]["tc"] == before["deconv"]["tc"] + 2
    x, w = _rand(rng, (1, 9, 10, 8), torch.float32, dev), w8.float()
    with pytest.raises(ValueError, match="tensor-core"):
        conv.conv(x, w, edition="tc")
    with pytest.raises(ValueError, match="tensor-core"):
        deconv.deconv(x, w, edition="tc")
    assert _editions() == after


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_tc_slab_equals_whole_volume(dev, stride):
    """A depth slab with real neighbour planes and pads (0, 0) in depth, as
    `parallel/halo.py` runs it, gives the whole conv's values bit for bit:
    each output's sum order does not depend on where its tile starts."""
    rng = np.random.default_rng(17)
    x = _rand(rng, (1, 16, 13, 19, 32), torch.bfloat16, dev)
    w = _rand(rng, (3, 3, 3, 32, 16), torch.bfloat16, dev, 0.1)
    b = _rand(rng, (16,), torch.float32, dev)
    whole = conv.conv(x, w, b, stride, True)
    hw = [conv.same_pads(n, 3, stride)[:2] for n in x.shape[2:4]]
    if stride == 1:
        slab = torch.cat([x[:, 3:4], x[:, 4:8], x[:, 8:9]], dim=1)
        want = whole[:, 4:8]
    else:
        slab = x[:, 4:9].contiguous()
        want = whole[:, 2:4]
    got = conv.conv(slab, w, b, stride, True, pads=[(0, 0)] + hw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("edition", ["tc", "simt"])
@pytest.mark.parametrize("shape,k,stride,cin,cout", [
    ((1, 6, 10, 16), 3, 1, 32, 8),                      # 3D s1 (3dconv0_1)
    ((1, 7, 11, 17), 3, 2, 32, 16),                     # 3D s2, odd sizes (3dconv1_0)
    ((1, 8, 12, 16), 3, 2, 8, 16),                      # the deconv dk's roles (3dconv6_0)
    ((1, 6, 10, 16), 3, 1, 8, 1),                       # Cout = 1 padded to 8 (3dconv6_2)
    ((1, 5, 6, 8), 3, 1, 64, 64),                       # 64 x 64 x 27: slices (3dconv3_1)
    ((2, 17, 24), 3, 1, 8, 8),                          # 2D 3x3 s1 (2dconv0_2)
    ((2, 15, 21), 3, 2, 16, 32),                        # 2D 3x3 s2
    ((2, 15, 21), 5, 2, 8, 16),                         # 2D 5x5 s2 (conv9_0)
    ((3, 7, 9), 3, 1, 128, 128),                        # 128 x 128 x 9 (2dconv4_1)
    ((3, 15, 20), 3, 2, 64, 128),                       # 2dconv5_0's dk
])
def test_wgrad_editions_match_plain(dev, edition, shape, k, stride, cin, cout):
    """bf16 inputs, float32 sums in both editions: float32's tolerance."""
    rng = np.random.default_rng(18)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), torch.bfloat16, dev)
    out = [conv.same_pads(n, k, stride)[2] for n in shape[1:]]
    g = _rand(rng, (shape[0], *out, cout), torch.bfloat16, dev)
    before = _editions()["wgrad"]
    got = wgrad.wgrad(x, g, (k,) * rank, stride, edition=edition)
    assert _editions()["wgrad"][edition] == before[edition] + 1
    _close(got, wgrad.wgrad_plain(x, g, (k,) * rank, stride), TOL[torch.float32])


# ---- Cin % 8 != 0 on the tensor cores: zero-padded in shared memory

SMALL_CIN = [1, 2, 3, 5, 6, 10]


@pytest.mark.parametrize("cin", SMALL_CIN)
@pytest.mark.parametrize("shape,k,stride", [((2, 13, 21), 3, 1), ((1, 15, 17), 3, 2),
                                            ((1, 11, 19), 5, 2), ((1, 5, 9, 11), 3, 1)])
def test_conv_tc_small_cin_matches_plain(dev, cin, shape, k, stride):
    """The conv kernel's tensor-core edition at Cin % 8 != 0, 2D 3x3 s1,
    3x3 s2, 5x5 s2 and 3D 3x3x3: bf16's tolerance against the plain
    version, one tc launch each."""
    rng = np.random.default_rng(cin * 10 + k + stride)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), torch.bfloat16, dev)
    w = _rand(rng, (k,) * rank + (cin, 8), torch.bfloat16, dev, (k ** rank * cin) ** -0.5)
    b = _rand(rng, (8,), torch.float32, dev)
    before = _editions()["conv"]
    got = conv.conv(x, w, b, stride, True)
    assert _editions()["conv"] == {"tc": before["tc"] + 1, "simt": before["simt"]}
    _close(got, conv.conv_plain(x, w, b, stride, True), TOL[torch.bfloat16])


@pytest.mark.parametrize("cin", SMALL_CIN)
@pytest.mark.parametrize("shape,k,lo,outs", [((2, 5, 7), 3, 0, None), ((1, 3, 4, 5), 3, 0, None),
                                             ((1, 8, 11), 5, 1, (15, 21))])
def test_deconv_tc_small_cin_matches_plain(dev, cin, shape, k, lo, outs):
    """The transposed conv's tensor-core edition at Cin % 8 != 0 (flax's
    3x3 s2 in 2D and 3D, the 5x5 adjoint): the plain version within bf16's
    tolerance, one tc launch each."""
    rng = np.random.default_rng(cin * 7 + k)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), torch.bfloat16, dev)
    w = _rand(rng, (k,) * rank + (cin, 8), torch.bfloat16, dev, (k * k * cin) ** -0.5)
    b = _rand(rng, (8,), torch.float32, dev)
    before = _editions()["deconv"]
    got = deconv.deconv(x, w, b, True, lo, outs)
    assert _editions()["deconv"] == {"tc": before["tc"] + 1, "simt": before["simt"]}
    _close(got, deconv.deconv_plain(x, w, b, True, lo, outs), TOL[torch.bfloat16])


@pytest.mark.parametrize("cin", SMALL_CIN)
@pytest.mark.parametrize("shape,k,stride,cout", [((2, 13, 21), 3, 1, 8), ((1, 15, 17), 3, 2, 16),
                                                 ((1, 11, 19), 5, 2, 8), ((1, 5, 9, 11), 3, 1, 1)])
def test_wgrad_tc_small_cin_matches_plain(dev, cin, shape, k, stride, cout):
    """K4w's tensor-core edition at Cin % 8 != 0: float32's tolerance against
    the plain version (bf16 inputs, float32 sums), one tc launch, and two
    calls equal bit for bit."""
    rng = np.random.default_rng(cin * 13 + k + stride)
    rank = len(shape) - 1
    x = _rand(rng, shape + (cin,), torch.bfloat16, dev)
    out = [conv.same_pads(n, k, stride)[2] for n in shape[1:]]
    g = _rand(rng, (shape[0], *out, cout), torch.bfloat16, dev)
    before = _editions()["wgrad"]
    got = wgrad.wgrad(x, g, (k,) * rank, stride)
    assert _editions()["wgrad"] == {"tc": before["tc"] + 1, "simt": before["simt"]}
    _close(got, wgrad.wgrad_plain(x, g, (k,) * rank, stride), TOL[torch.float32])
    assert torch.equal(got, wgrad.wgrad(x, g, (k,) * rank, stride))


@pytest.mark.parametrize("cin", [3, 5])
def test_small_cin_simt_edition_still_runs(dev, cin):
    """`edition="simt"` keeps the CUDA-core kernels reachable for bf16 at a
    small Cin: conv, transposed conv and weight gradient, each against its
    plain version."""
    rng = np.random.default_rng(cin)
    x = _rand(rng, (1, 13, 17, cin), torch.bfloat16, dev)
    w = _rand(rng, (3, 3, cin, 8), torch.bfloat16, dev, (9 * cin) ** -0.5)
    g = _rand(rng, (1, 13, 17, 8), torch.bfloat16, dev)
    before = _editions()
    _close(conv.conv(x, w, None, 1, False, edition="simt"), conv.conv_plain(x, w),
           TOL[torch.bfloat16])
    _close(deconv.deconv(x, w, edition="simt"), deconv.deconv_plain(x, w), TOL[torch.bfloat16])
    _close(wgrad.wgrad(x, g, (3, 3), 1, edition="simt"), wgrad.wgrad_plain(x, g, (3, 3), 1),
           TOL[torch.float32])
    after = _editions()
    assert all(after[k]["simt"] == before[k]["simt"] + 1 for k in after)
    assert all(after[k]["tc"] == before[k]["tc"] for k in after)


def test_small_cin_rows_of_a_block_equal_the_whole_map(dev):
    """The image conv on a row block at explicit pads, as the tower's row
    blocks run it, gives the whole map's rows bit for bit: a Cin of 3 is
    padded alike whatever the shape, and each output sums in one order."""
    rng = np.random.default_rng(21)
    x = _rand(rng, (1, 40, 40, 3), torch.bfloat16, dev)     # rows of 240 bytes
    w = _rand(rng, (3, 3, 3, 8), torch.bfloat16, dev, 0.2)
    whole = conv.conv(x, w, None, 1, False)
    got = conv.conv(x[:, 9:31], w, None, 1, False, pads=[(0, 0), (1, 1)])
    assert torch.equal(got, whole[:, 10:30])


def test_wgrad_tc_is_deterministic(dev):
    """Two tc calls on the same inputs are equal bit for bit: every block's
    partial sums its tiles in one order and the second pass adds the
    partials in one order (no atomics)."""
    rng = np.random.default_rng(19)
    x = _rand(rng, (1, 24, 30, 40, 32), torch.bfloat16, dev)
    g = _rand(rng, (1, 12, 15, 20, 16), torch.bfloat16, dev)
    a = wgrad.wgrad(x, g, (3, 3, 3), 2, edition="tc")
    b = wgrad.wgrad(x, g, (3, 3, 3), 2, edition="tc")
    assert torch.equal(a, b)


def test_wgrad_edition_rule_on_card(dev):
    """bf16 runs "tc" by default (Cin = 3 and Cout = 1 too); float32 runs
    "simt", and asking for "tc" on it raises before any launch."""
    rng = np.random.default_rng(20)
    cases = [((1, 9, 10, 8), (1, 9, 10, 8), torch.bfloat16, "tc"),
             ((1, 9, 10, 3), (1, 9, 10, 8), torch.bfloat16, "tc"),
             ((1, 9, 10, 8), (1, 9, 10, 1), torch.bfloat16, "tc"),
             ((1, 9, 10, 8), (1, 9, 10, 8), torch.float32, "simt")]
    for xs, gs, dtype, want in cases:
        x, g = _rand(rng, xs, dtype, dev), _rand(rng, gs, dtype, dev)
        before = _editions()["wgrad"]
        wgrad.wgrad(x, g, (3, 3), 1)
        assert _editions()["wgrad"][want] == before[want] + 1
        if want == "simt":
            with pytest.raises(ValueError, match="tensor-core"):
                wgrad.wgrad(x, g, (3, 3), 1, edition="tc")
            assert _editions()["wgrad"][want] == before[want] + 1


def _driver_run(tmp_path, device, extra):
    """`mvsnet_tpu_torch.train.main` on `device` over plane scenes rendered
    in memory (a card machine may lack an image codec), lite, 64x64, D=8,
    float32; returns the model dir."""
    from mvsnet_tpu_torch import train as driver
    from mvsnet_tpu_torch.data.synthetic import SyntheticGenerator, render_session

    sessions = [render_session(n_images=4, seed=1)]

    def make_loader(dcfg, tcfg, mode):
        return lambda: SyntheticGenerator(
            sessions, view_num=3, image_width=64, image_height=64, depth_num=8,
            base_image_size=32, mode=mode, flip_cams=False, seed=tcfg.seed)

    model_dir = str(tmp_path / f"run_{torch.device(device).type}")
    real = driver.make_loader
    driver.make_loader = make_loader
    try:
        rc = driver.main(["--train_data_root", str(tmp_path / "data"), "--model_dir", model_dir,
                          "--view_num", "3", "--max_d", "8", "--width", "64", "--height", "64",
                          "--base_image_size", "32", "--network_mode", "lite",
                          "--compute_dtype", "float32", "--loader_workers", "1",
                          "--device", str(device), *extra])
    finally:
        driver.make_loader = real
    assert rc == 0
    return model_dir


def test_driver_step_card_matches_cpu(dev, tmp_path):
    """One step of the training driver on the card against the CPU's plain
    path from the same checkpoint (non-identity norms), phase 7's bounds:
    loss and running statistics to 1e-4, gradients to 2e-2 in the norm of
    all leaves and 1e-1 of each leaf's largest entry. The step is SGD at
    rate 1000 from zero momentum, so each update is -1000 times the
    gradient and the checkpoints carry the gradients."""
    import json

    from mvsnet_tpu_torch import checkpoint

    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, network_mode="lite",
                      compute_dtype="float32")
    tcfg = TrainConfig(optimizer="momentum")
    model = MVSNet(cfg, seed=5)
    _perturb_norms(model, 6)
    start = str(tmp_path / "start")
    checkpoint.save_checkpoint(start, "3DCNN", "lite", 0,
                               train_lib.create_train_state(model, cfg, tcfg, device="cpu"))
    extra = ["--model_load_dir", start, "--ckpt_step", "0", "--optimizer", "momentum",
             "--base_lr", "1000", "--max_steps_per_epoch", "1", "--loss_type", "power"]
    runs = {}
    for device in (dev, "cpu"):
        model_dir = _driver_run(tmp_path, device, extra)
        with open(f"{model_dir}/metrics.jsonl") as f:
            loss = [json.loads(line)["loss"] for line in f if "loss" in line][0]
        runs[device] = (loss, checkpoint.restore_tree(model_dir, "3DCNN", "lite", 1)["model"])
    (l_gpu, sd_gpu), (l_cpu, sd_cpu) = runs[dev], runs["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    before = model.state_dict()
    params = dict(model.named_parameters())
    num = den = 0.0
    for name, w in sd_cpu.items():
        got = sd_gpu[name]
        if name in params:
            g_cpu, g_gpu = (before[name] - w) / 1000, (before[name] - got) / 1000
            assert torch.isfinite(g_gpu).all(), name
            assert (g_gpu - g_cpu).abs().max() <= 1e-1 * max(g_cpu.abs().max().item(), 1e-12), name
            num += ((g_gpu - g_cpu) ** 2).sum().item()
            den += (g_cpu ** 2).sum().item()
        else:
            assert (got - w).abs().max() <= 1e-4 * max(1.0, w.abs().max().item()), name
    assert (num / den) ** 0.5 <= 2e-2


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A card state after two train steps saves and restores on the card bit
    for bit: parameters, statistics, RMSprop state, step."""
    from mvsnet_tpu_torch import checkpoint

    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, network_mode="lite",
                      compute_dtype="bfloat16")
    tcfg = TrainConfig()
    rng = np.random.default_rng(21)
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = np.eye(4)
    cam[1, :3, :3] = [[15.0, 0, 8], [0, 15.0, 8], [0, 0, 1]]
    cam[1, 3] = [5.0, 0.5, 8, 8.5]
    cams = np.stack([cam] * 3)[None].copy()
    cams[0, 1, 0, 0, 3] = 0.3
    gt = rng.uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    batch = (rng.standard_normal((1, 3, 64, 64, 3)).astype(np.float32), cams, gt, gt)
    model = MVSNet(cfg, seed=7)
    state = train_lib.create_train_state(model, cfg, tcfg, device=dev)
    step = train_lib.make_train_step(model, cfg, tcfg)
    for _ in range(2):
        state, _ = step(state, batch)
    checkpoint.save_checkpoint(str(tmp_path), "3DCNN", "lite", 2, state)
    fresh = train_lib.create_train_state(MVSNet(cfg, seed=8), cfg, tcfg, device=dev)
    checkpoint.restore_checkpoint(str(tmp_path), "3DCNN", "lite", fresh)
    assert fresh.step == state.step == 2
    assert fresh.device == dev
    for (k, a), (_, b) in zip(state.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(state.optimizer.state[p]["nu"], fresh.optimizer.state[q]["nu"])


def test_entry_forward_on_card(dev):
    """`entry()` puts its model and example arguments on cuda:0; the forward
    launches the cost-volume kernel once and gives finite maps in the depth
    range."""
    from mvsnet_tpu_torch.entry import entry
    from mvsnet_tpu_torch.ops import kernels

    forward, args = entry()
    model, images, cams, ds, di = args
    assert images.device.type == "cuda" and next(model.parameters()).device.type == "cuda"
    before = kernels.launch_counts()
    depth, prob = forward(*args)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["cost_volume"] == before["cost_volume"] + 1
    assert after["conv"] > before["conv"] and after["deconv"] > before["deconv"]
    assert depth.shape == prob.shape == (1, 16, 16, 1)
    assert torch.isfinite(depth).all() and torch.isfinite(prob).all()
    assert ds.item() - 1e-3 <= depth.min().item() and depth.max().item() <= ds.item() + 7 * di.item() + 1e-3


# ---- the R-MVSNet ConvGRU path

# the GRU cells' convs (Cin, Cout) in "normal" mode: gates and output convs
# of the three cells, prob_conv, and Cout = 1 from 48 channels
GRU_CONVS = [(48, 32), (48, 16), (20, 8), (20, 4), (6, 4), (6, 2), (2, 1), (48, 1)]


@pytest.mark.parametrize("dtype,edition", [(torch.bfloat16, "tc"), (torch.bfloat16, "simt"),
                                           (torch.float32, "simt")])
@pytest.mark.parametrize("cin,cout", GRU_CONVS)
def test_gru_cell_convs_match_plain(dev, dtype, edition, cin, cout):
    """A GRU cell's 3x3 SAME conv with bias and no ReLU at a feature map of
    37x50 (odd, not a multiple of any tile), in each edition that takes
    it (the tensor cores take bf16 at any Cin: 20, 6 and 2 zero-padded)."""
    rng = np.random.default_rng(cin * 100 + cout)
    x = _rand(rng, (1, 37, 50, cin), dtype, dev)
    w = _rand(rng, (3, 3, cin, cout), dtype, dev, (9 * cin) ** -0.5)
    b = _rand(rng, (cout,), torch.float32, dev)
    before = dict(conv.launches_by_edition)
    got = conv.conv(x, w, b, 1, False, edition=edition)
    assert conv.launches_by_edition[edition] == before[edition] + 1
    _close(got, conv.conv_plain(x, w, b, 1, False), TOL[dtype])


def _gru_model(dev, dtype="bfloat16", mode="normal", max_d=12, seed=3):
    cfg = ModelConfig(view_num=3, max_d=max_d, width=160, height=96, network_mode=mode,
                      regularization="GRU", compute_dtype=dtype)
    model = MVSNet(cfg, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():                       # non-identity norms
        for name, p in model.named_parameters():
            if name.endswith("norm.scale"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            elif name.endswith("norm.bias") or name.endswith("conv.bias"):
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return cfg, model.to(dev).eval()


@pytest.mark.parametrize("wta", [True, False])
def test_gru_graph_replay_equals_eager_sweep(dev, wta):
    """The captured depth step replayed D times gives the eager sweep's regs
    and winner-take-all carry bit for bit on the same cost volume, a second
    sweep (states reset, graph reused) gives them again, and the replays
    count the launches the eager sweep counts."""
    from mvsnet_tpu_torch.ops import kernels

    cfg, model = _gru_model(dev)
    rng = np.random.default_rng(30)
    cost = _rand(rng, (1, cfg.max_d, 24, 40, 32), torch.bfloat16, dev).abs()
    samples = (torch.linspace(5.0, 10.5, cfg.max_d, device=dev)[None] if wta else None)
    sweep = model.gru_sweep
    with torch.inference_mode():
        before = kernels.launch_counts()
        regs_e, carry_e = sweep.eager(cost, samples)
        eager_counts = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        sweep.graphed(cost, samples)                     # captures
        before = kernels.launch_counts()
        regs_g, carry_g = sweep.graphed(cost, samples)
        torch.cuda.synchronize()
        graph_counts = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        again = sweep(cost, samples)                      # eval, no autograd: the graph
    assert len(sweep._graphs) == 1
    assert graph_counts == eager_counts and eager_counts["conv"] == 7 * cfg.max_d
    assert torch.equal(regs_g, regs_e) and torch.equal(again[0], regs_e)
    if wta:
        assert all(torch.equal(a, b) for a, b in zip(carry_g, carry_e))
        assert all(torch.equal(a, b) for a, b in zip(again[1], carry_e))
    else:
        assert carry_g is None and carry_e is None


def test_gru_graph_follows_reloaded_weights(dev):
    """A load with `assign` moves the parameters, which a capture reads by
    address: the sweep drops its graph, captures once more and replays the
    new weights, equal bit for bit to the eager sweep, with one graph in
    its cache."""
    cfg, model = _gru_model(dev)
    _, other = _gru_model(dev, seed=9)
    rng = np.random.default_rng(33)
    cost = _rand(rng, (1, cfg.max_d, 24, 40, 32), torch.bfloat16, dev).abs()
    samples = torch.linspace(5.0, 10.5, cfg.max_d, device=dev)[None]
    sweep = model.gru_sweep
    with torch.inference_mode():
        old, _ = sweep.graphed(cost, samples)
    model.load_state_dict(other.state_dict(), assign=True)
    with torch.inference_mode():
        new, carry = sweep.graphed(cost, samples)
        want, want_carry = sweep.eager(cost, samples)
    assert len(sweep._graphs) == 1
    assert torch.equal(new, want) and not torch.equal(old, new)
    assert all(torch.equal(a, b) for a, b in zip(carry, want_carry))


def test_gru_predictor_card_matches_cpu(dev):
    """R-MVSNet serving (graph-replayed sweep) on the card against the CPU's
    plain path, float32: regs within 1e-3 of max(1, max|regs|), depth equal
    wherever a pixel's top two regs differ by more than that, prob within
    1e-3 (phase 5's bound)."""
    from mvsnet_tpu_torch.predict import Predictor

    cfg, model = _gru_model(dev, dtype="float32", max_d=16)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(31)
    images = rng.standard_normal((1, 3, 96, 160, 3)).astype(np.float32)
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = np.eye(4)
    cam[1, :3, :3] = [[30.0, 0, 20], [0, 30.0, 12], [0, 0, 1]]
    cam[1, 3] = [5.0, 0.5, 16, 12.5]
    cams = np.stack([cam] * 3)[None].copy()
    cams[0, 1, 0, 0, 3] = 0.4
    cams[0, 2, 0, 1, 3] = -0.3
    inputs = (images, cams, cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1], cams[:, 0, 1, 3, 3])
    out = {}
    for device in (dev, "cpu"):
        p = Predictor(cfg, state_dict=sd, device=device)
        with torch.inference_mode():
            t = [torch.as_tensor(a, device=p.device) for a in inputs]
            out[str(device)] = [o.cpu() for o in p.model.forward_gru_wta(
                t[0], t[1], t[2], None, t[4], with_regs=True)]
        depth, prob, _ = p.predict(*inputs)
        np.testing.assert_array_equal(depth, out[str(device)][0].numpy())
    (d_g, p_g, r_g), (d_c, p_c, r_c) = out[str(dev)], out["cpu"]
    tol = 1e-3 * max(1.0, r_c.abs().max().item())
    assert (r_g - r_c).abs().max().item() <= tol
    top2 = r_c.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1] > tol)[..., None]
    assert decided.float().mean().item() > 0.5
    assert torch.equal(d_g[decided], d_c[decided])
    assert (p_g - p_c).abs().max().item() <= 1e-3


def _gru_train_batch():
    """A 96x160 training batch for `_gru_model` (D=12 from 5.0 by 0.5)."""
    rng = np.random.default_rng(32)
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = np.eye(4)
    cam[1, :3, :3] = [[30.0, 0, 20], [0, 30.0, 12], [0, 0, 1]]
    cam[1, 3] = [5.0, 0.5, 12, 10.5]
    cams = np.stack([cam] * 3)[None].copy()
    cams[0, 1, 0, 0, 3] = 0.4
    gt = rng.uniform(5.0, 10.5, (1, 24, 40, 1)).astype(np.float32)
    return (rng.standard_normal((1, 3, 96, 160, 3)).astype(np.float32), cams, gt, gt)


def test_gru_train_steps_are_bit_equal_on_card(dev):
    """Two float32 GRU train steps on the card from one state and batch give
    the same loss and gradients bit for bit (every kernel of the step sums
    in a fixed order; the classification loss picks with a one-hot product,
    not an atomic scatter), and the step launches K1, K2, K3, the conv and
    the weight-gradient kernels."""
    from mvsnet_tpu_torch.ops import kernels

    batch = _gru_train_batch()
    runs = []
    for _ in range(2):
        cfg, model = _gru_model(dev, dtype="float32")
        state = train_lib.create_train_state(model, cfg, TrainConfig(), device=dev)
        before = kernels.launch_counts()
        _, metrics = train_lib.make_train_step(model, cfg, TrainConfig())(state, batch)
        counts = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        runs.append((metrics["loss"].item(), [p.grad.clone() for p in model.parameters()]))
    assert all(counts[k] > 0 for k in ("cost_volume", "conv", "warp", "warp_transpose", "wgrad"))
    assert np.isfinite(runs[0][0]) and runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_remat_step_equals_eager_step_on_card(dev, dtype):
    """A train step whose sweep recomputes its depth steps in the backward
    pass (`GRUSweep.remat`, which training takes) gives the loss and every
    gradient of a step whose sweep runs under autograd (`GRUSweep.eager` put
    in its place) bit for bit, on `_gru_train_batch` from one seeded state;
    the recomputing step launches each cell conv once a plane more, in the
    dtype's edition, and every other kernel as often."""
    from mvsnet_tpu_torch.models.layers import Conv
    from mvsnet_tpu_torch.ops import kernels

    batch = _gru_train_batch()
    runs = []
    for kind in ("remat", "eager"):
        cfg, model = _gru_model(dev, dtype=dtype)
        if kind == "eager":
            model.gru_sweep.forward = model.gru_sweep.eager
        state = train_lib.create_train_state(model, cfg, TrainConfig(), device=dev)
        before, ed_before = kernels.launch_counts(), kernels.edition_counts()
        _, metrics = train_lib.make_train_step(model, cfg, TrainConfig())(state, batch)
        counts = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        editions = {k: {e: n - ed_before[k][e] for e, n in eds.items()}
                    for k, eds in kernels.edition_counts().items()}
        runs.append((metrics["loss"].item(), [p.grad for p in model.parameters()], counts,
                     editions))
    (loss, grads, counts, editions), (loss_e, grads_e, counts_e, editions_e) = runs
    assert np.isfinite(loss) and loss == loss_e
    assert len(grads) == len(grads_e) and all(torch.equal(a, b) for a, b in zip(grads, grads_e))
    recompute = cfg.max_d * sum(isinstance(m, Conv) for m in model.gru_sweep.modules())
    assert recompute == 7 * cfg.max_d
    assert counts == dict(counts_e, conv=counts_e["conv"] + recompute)
    editions_e["conv"]["tc" if dtype == "bfloat16" else "simt"] += recompute
    assert editions == editions_e


# refinement (the training driver's defaults: U-Net, upsampled, confidence)
REFINED = dict(refinement=True, refinement_network="unet", upsample_before_refinement=True,
               refine_with_confidence=True)


def _refine_scene(rng, B=1, H=128, W=160, D=16):
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = np.eye(4)
    cam[1, :3, :3] = [[30.0, 0, W / 8], [0, 30.0, H / 8], [0, 0, 1]]
    cam[1, 3] = [5.0, 0.5, D, 5.0 + 0.5 * (D - 1)]
    cams = np.stack([cam] * 3)[None].repeat(B, axis=0)
    cams[:, 1, 0, 0, 3] = 0.4
    cams[:, 2, 0, 1, 3] = -0.3
    images = rng.standard_normal((B, 3, H, W, 3)).astype(np.float32)
    return images, cams


def test_resize_on_card_matches_cpu_and_repeats(dev):
    """`ops/resize.resize_bilinear` up and down on the card: within 1e-5 of
    the CPU, and two forward and backward passes equal bit for bit (matrix
    products, no atomics)."""
    from mvsnet_tpu_torch.ops.resize import resize_bilinear

    x = torch.randn(2, 54, 72, 3, generator=torch.Generator().manual_seed(4))
    for size in ((216, 288), (13, 18)):
        want = resize_bilinear(x, *size)
        runs = []
        for _ in range(2):
            xg = x.to(dev).requires_grad_()
            y = resize_bilinear(xg, *size)
            y.backward(torch.ones_like(y) * 0.5)
            runs.append((y.detach(), xg.grad))
        assert (runs[0][0].cpu() - want).abs().max().item() <= 1e-5
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refined_predictor_card_matches_cpu(dev, dtype):
    """A refined request (`normal`, 128x160, D=16) on the card against the
    CPU's plain path: in float32 the refined depth within phase 5's 0.05,
    prob 1e-3, the residual within 1e-3 of max(1, max|residual|); in
    bfloat16 every conv and transposed conv runs the tensor cores (the
    tower's two image convs and the refinement net's two Cin = 5 convs
    too), and the maps are finite."""
    from mvsnet_tpu_torch.ops import kernels

    cfg = ModelConfig(view_num=3, max_d=16, width=160, height=128, network_mode="normal",
                      compute_dtype=dtype, **REFINED)
    sd = MVSNet(cfg, seed=7).state_dict()
    images, cams = _refine_scene(np.random.default_rng(33))
    inputs = (images, cams, cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1], cams[:, 0, 1, 3, 3])
    before = kernels.edition_counts()
    card = Predictor(cfg, state_dict=sd, device=dev).predict(*inputs)
    after = kernels.edition_counts()
    assert all(np.isfinite(o).all() for o in card) and card[0].shape == (1, 128, 160, 1)
    if dtype == "bfloat16":
        # the tower's two image convs and the refinement net's two Cin = 5
        # convs zero-padded in shared memory
        assert after["conv"]["simt"] - before["conv"]["simt"] == 0
        assert after["conv"]["tc"] - before["conv"]["tc"] == 60
        assert after["deconv"]["tc"] - before["deconv"]["tc"] == 11
        return
    cpu = Predictor(cfg, state_dict=sd, device="cpu").predict(*inputs)
    assert np.abs(card[0] - cpu[0]).max() <= 0.05
    assert np.abs(card[1] - cpu[1]).max() <= 1e-3
    assert np.abs(card[2] - cpu[2]).max() <= 1e-3 * max(1.0, np.abs(cpu[2]).max())


def test_refined_train_step_card_matches_cpu_and_repeats(dev):
    """One float32 train step with refinement ("all" mode; `normal`, 64x64,
    D=8, norms perturbed) on the card against the CPU under
    `test_tiny_train_step_card_matches_cpu`'s bounds, and two card steps
    from one state and batch equal bit for bit."""
    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, network_mode="normal",
                      compute_dtype="float32", **REFINED)
    tcfg = TrainConfig()
    rng = np.random.default_rng(34)
    images, cams = _refine_scene(rng, H=64, W=64, D=8)
    gt = rng.uniform(5.0, 8.5, (1, 16, 16, 1)).astype(np.float32)
    batch = (images, cams, gt, np.repeat(np.repeat(gt, 4, axis=1), 4, axis=2))
    runs = []
    for device in (dev, dev, "cpu"):
        model = MVSNet(cfg, seed=5)
        _perturb_norms(model, 6)
        state = train_lib.create_train_state(model, cfg, tcfg, device=device)
        _, metrics = train_lib.make_train_step(model, cfg, tcfg)(state, batch)
        runs.append((metrics["loss"].item(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (l_a, g_a), (l_b, g_b), (l_c, g_c) = runs
    assert l_a == l_b and all(torch.equal(g_a[n], g_b[n]) for n in g_a)
    assert any(n.startswith("refine_net.") for n in g_a)
    assert abs(l_a - l_c) <= 1e-4 * abs(l_c)
    num = den = 0.0
    for name, want in g_c.items():
        got = g_a[name]
        assert torch.isfinite(got).all(), name
        assert (got - want).abs().max() <= 2e-2 * max(want.abs().max().item(), 1e-12), name
        num, den = num + ((got - want) ** 2).sum().item(), den + (want ** 2).sum().item()
    assert (num / den) ** 0.5 <= 5e-3


# ---------------------------------------------------------------- fusion (slice 5b)


def _sphere_views(H=96, W=96, grid=(2, 2), baseline=60.0):
    """tests/test_fusion_quality.py's scene (a sphere cap of radius 400 at
    z = 2000 before a plane at 2400) from translated cameras, in numpy:
    (depths, cams)."""
    center, radius, bg = np.array([0.0, 0.0, 2000.0]), 400.0, 2400.0
    f = W * 1.2
    us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    d = np.stack([(us - W / 2.0) / f, (vs - H / 2.0) / f, np.ones_like(us)], axis=-1)
    a = (d * d).sum(-1)
    depths, cams = [], []
    for r in range(grid[0]):
        for c in range(grid[1]):
            pos = np.array([baseline * (c - 0.5 * (grid[1] - 1)),
                            baseline * (r - 0.5 * (grid[0] - 1)), 0.0])
            oc = pos - center
            b = 2.0 * (d @ oc)
            disc = b * b - 4 * a * ((oc * oc).sum() - radius ** 2)
            t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), 0.0)
            depths.append(np.where((disc > 0) & (t > 0), t * d[..., 2], bg).astype(np.float32))
            cam = np.zeros((2, 4, 4))
            cam[0] = np.eye(4)
            cam[0, :3, 3] = -pos
            cam[1, :3, :3] = [[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]]
            cam[1, 3] = [1500.0, 1000 / 7, 8, 2500.0]
            cams.append(cam)
    return depths, cams


@pytest.mark.parametrize("thresholds", [(0.25, 3), (1.0, 2)])
def test_fusion_on_card_matches_cpu(dev, thresholds):
    """Each reference view of the 4-view sphere scene at 96x96: the keep
    masks on the card and on the CPU differ at no more than 1e-3 of the
    pixels; where both keep a pixel with the same count, the fused points
    agree within 1e-4 of the background's depth (2400 mm)."""
    from mvsnet_tpu_torch import fusion

    disp, n = thresholds
    depths, cams = _sphere_views()
    runs = []
    for d in (dev, "cpu"):
        views = fusion.prepare_views(depths, cams, d)
        runs.append([tuple(x.cpu() for x in fusion.consistency(views, i, disp, 0.01))
                     for i in range(4)])
    differ = kept = 0
    for depth, (cg, ag), (cc, ac) in zip(depths, *runs):
        valid = torch.as_tensor(depth) > 0
        kg, kc = valid & (cg >= n), valid & (cc >= n)
        differ += int((kg != kc).sum())
        kept += int(kc.sum())
        both = kg & kc & (cg == cc)
        pg, pc = ag / (cg[..., None] + 1.0), ac / (cc[..., None] + 1.0)
        assert float((pg - pc).abs()[both].max()) <= 1e-4 * 2400
    assert kept > 3000 and differ <= 1e-3 * 4 * 96 * 96


def test_fuse_session_on_card_writes_the_cpu_cloud(dev, tmp_path):
    """`fusion.fuse_session` on the card against `device="cpu"`, through the
    files (prob-filtered PFMs, cams, PLY): equal point counts and colours,
    points within 1e-4 of 2400 mm. The reference image is read by a
    substituted loader (the card machine has no JPEG codec)."""
    from mvsnet_tpu_torch import fusion
    from mvsnet_tpu_torch.io.cams import write_cam_txt
    from mvsnet_tpu_torch.io.pfm import write_pfm
    from mvsnet_tpu_torch.io.ply import read_ply

    depths, cams = _sphere_views()
    out = tmp_path / "depths_mvsnet"
    out.mkdir()
    for i, (depth, cam) in enumerate(zip(depths, cams)):
        write_pfm(str(out / f"{i}_init.pfm"), depth)
        write_pfm(str(out / f"{i}_prob.pfm"), np.ones_like(depth))
        write_cam_txt(str(out / f"{i}.txt"), cam)
        (out / f"{i}.jpg").write_bytes(b"")
    real = fusion.load_image
    fusion.load_image = lambda path: np.full((96, 96, 3), 7 * int(path[-5]), np.uint8)
    try:
        clouds = [read_ply(fusion.fuse_session(str(tmp_path), 0.5, 1.0, 2, 0.01,
                                               output_path=str(tmp_path / f"{d}.ply"),
                                               device=d)) for d in (dev, "cpu")]
    finally:
        fusion.load_image = real
    (pg, cg), (pc, cc) = clouds
    assert len(pg) == len(pc) > 3000
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_allclose(pg, pc, atol=1e-4 * 2400, rtol=0)


def test_native_library_builds_and_matches_plain(dev):
    """The card machine builds `native/pointcloud.cpp` with its g++ into
    `_build/`; the library equals the numpy plain versions."""
    from mvsnet_tpu_torch import native

    assert native.load().native_pointcloud_abi_version() == 1
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((20000, 3)) * 10).astype(np.float32)
    cols = rng.integers(0, 255, (20000, 3), dtype=np.uint8)
    got, want = (native.voxel_downsample(pts, cols, 0.7),
                 native.voxel_downsample_plain(pts, cols, 0.7))
    og, ow = np.lexsort(got[0].T[::-1]), np.lexsort(want[0].T[::-1])
    np.testing.assert_array_equal(got[0][og], want[0][ow])
    np.testing.assert_array_equal(got[1][og], want[1][ow])
    np.testing.assert_array_equal(native.radius_outlier_removal(pts, 0.7, 5),
                                  native.radius_outlier_removal_plain(pts, 0.7, 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_row_blocks_stitch_and_match_plain(dev, dtype):
    """K2 and K3 with a row offset (the blocked train step's cost volume):
    K2's row blocks stitched equal one whole launch bit for bit (the same
    arithmetic per pixel), K3's blocks' source-map gradients add up to the
    whole launch's, and each block matches its plain version; the launches
    count apart."""
    rng = np.random.default_rng(21)
    img = _rand(rng, (20, 28, 16), dtype, dev)
    g = _rand(rng, (12, 20, 28, 16), dtype, dev)
    for homs in (_homs(12, 0.02, 12.0, dev), _degenerate_homs(12, dev)):
        before = (warp.launches_sharded, warp.transpose_launches_sharded)
        blocks = [(0, 7), (7, 6), (13, 7)]
        stitched = torch.cat([warp.warp_all_depths(img, homs, r, n) for r, n in blocks], dim=1)
        assert torch.equal(stitched, warp.warp_all_depths(img, homs))
        parts = [warp.warp_transpose(g[:, r:r + n], homs, r, 20) for r, n in blocks]
        assert (warp.launches_sharded, warp.transpose_launches_sharded) == \
            (before[0] + 3, before[1] + 3)
        _close(sum(parts), warp.warp_transpose(g, homs), TOL[torch.float32])
        for (r, n), part in zip(blocks, parts):
            _close(warp.warp_all_depths(img, homs, r, n),
                   warp.warp_all_depths_plain(img, homs, r, n), TOL[dtype])
            _close(part, warp.warp_transpose_plain(g[:, r:r + n], homs, r, 20),
                   TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_halo_conv_gradients_match_plain(dev, dtype, stride):
    """The halo conv's training ops at explicit pads (`ops/autograd.py`):
    forward, input gradient (stride 1: the conv at pads 2; stride 2: the
    transposed conv at low pad 0) and K4w on the halo-extended input, on
    the card against the plain path."""
    rng = np.random.default_rng(22)
    n = 9 if stride == 1 else 7
    x = _rand(rng, (1, n, 9, 12, 16), dtype, dev)
    k = _rand(rng, (3, 3, 3, 16, 8), dtype, dev, 0.05)
    pads = [(0, 0), (0, 0), (1, 1)] if stride == 1 else [(0, 0), (0, 0), (0, 1)]
    out = [(m - 3) // stride + 1 for m in (n, 9)] + [-(-12 // stride)]
    g = _rand(rng, (1, *out, 8), dtype, dev)
    grads = []
    for d in (dev, "cpu"):
        xx = x.detach().to(d).requires_grad_(True)
        kk = k.detach().to(d).requires_grad_(True)
        y = autograd.ConvFn.apply(xx, kk, stride, pads)
        (y.float() * g.to(d).float()).sum().backward()
        grads.append((y.detach().cpu(), xx.grad.cpu(), kk.grad.cpu()))
    for got, want in zip(*grads):
        _close(got, want, TOL[dtype])


def test_halo_deconv_gradients_match_plain(dev):
    """The halo transposed conv's training op at an explicit crop (lo 1, an
    odd block start): forward, input gradient (a stride-2 conv at pads
    (lo, 2 (n-1) + 3 - m - lo)) and dk, card against the plain path."""
    rng = np.random.default_rng(23)
    x = _rand(rng, (1, 5, 6, 7, 16), torch.bfloat16, dev)
    k = _rand(rng, (3, 3, 3, 16, 8), torch.bfloat16, dev, 0.05)
    lo, outs = (1, 2, 0), (7, 9, 14)
    g = _rand(rng, (1, *outs, 8), torch.bfloat16, dev)
    grads = []
    for d in (dev, "cpu"):
        xx = x.detach().to(d).requires_grad_(True)
        kk = k.detach().to(d).requires_grad_(True)
        y = autograd.DeconvFn.apply(xx, kk, lo, outs)
        (y.float() * g.to(d).float()).sum().backward()
        grads.append((y.detach().cpu(), xx.grad.cpu(), kk.grad.cpu()))
    for got, want in zip(*grads):
        _close(got, want, TOL[torch.bfloat16])
