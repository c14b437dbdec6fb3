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
    """bf16 with Cin % 8 == 0 runs "tc" by default; float32 and Cin = 3 run
    "simt", and asking for "tc" on them raises before any launch."""
    rng = np.random.default_rng(16)
    w8 = _rand(rng, (3, 3, 8, 8), torch.bfloat16, dev)
    before = _editions()
    conv.conv(_rand(rng, (1, 9, 10, 8), torch.bfloat16, dev), w8)
    conv.conv(_rand(rng, (1, 9, 10, 3), torch.bfloat16, dev), w8[:, :, :3])
    conv.conv(_rand(rng, (1, 9, 10, 8), torch.float32, dev), w8.float())
    deconv.deconv(_rand(rng, (1, 4, 5, 8), torch.bfloat16, dev), w8)
    after = _editions()
    assert after["conv"] == {"tc": before["conv"]["tc"] + 1, "simt": before["conv"]["simt"] + 2}
    assert after["deconv"]["tc"] == before["deconv"]["tc"] + 1
    for x, w in ((_rand(rng, (1, 9, 10, 8), torch.float32, dev), w8.float()),
                 (_rand(rng, (1, 9, 10, 3), torch.bfloat16, dev), w8[:, :, :3])):
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
    """bf16 with Cin % 8 == 0 runs "tc" by default (Cout = 1 too); float32
    and Cin = 3 run "simt", and asking for "tc" on them raises before any
    launch."""
    rng = np.random.default_rng(20)
    cases = [((1, 9, 10, 8), (1, 9, 10, 8), torch.bfloat16, "tc"),
             ((1, 9, 10, 3), (1, 9, 10, 8), torch.bfloat16, "simt"),
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
