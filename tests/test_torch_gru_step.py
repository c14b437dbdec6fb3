"""The fused GRU depth step's plain twin (`ops/kernels/gru_step`) and its
buffers (`models/mvsnet._FusedStep`) on the CPU, where the kernels do not
run: the twin's layer-norm statistics against float64 numpy; the fused
step's [x | slot] buffers over a few planes against the present step
(`GRUSweep.step`, `ConvGRUCell.forward`) with the twin's norm in place of
`GroupNormFlexible`'s, bit for bit; and against the present step as it
is, within a stated tolerance. The card tests (tests/test_torch_cuda.py,
`-k gru_step`) hold the kernels to the twin bit for bit.
"""

import numpy as np
import pytest
import torch

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.models import MVSNet
from mvsnet_tpu_torch.models import mvsnet as port_mvsnet
from mvsnet_tpu_torch.models.layers import GroupNormFlexible
from mvsnet_tpu_torch.ops.kernels import gru_step
from mvsnet_tpu_torch.utils import profiling


def _model(mode, seed=3):
    cfg = ModelConfig(view_num=3, max_d=6, width=64, height=48, network_mode=mode,
                      regularization="GRU", compute_dtype="bfloat16")
    model = MVSNet(cfg, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():                       # non-identity norms, biases
        for name, p in model.named_parameters():
            if name.endswith("norm.scale"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            elif name.endswith("norm.bias") or name.endswith("conv.bias"):
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return cfg, model


def _cost(cfg, B, h, w, seed=5):
    g = torch.Generator().manual_seed(seed)
    cost = torch.rand((B, cfg.max_d, h, w, cfg.feature_channels), generator=g) * 2
    samples = torch.linspace(5.0, 9.0, cfg.max_d)[None].expand(B, -1).contiguous()
    return cost.to(torch.bfloat16), samples


@pytest.fixture
def twin_norms(monkeypatch):
    """`GroupNormFlexible` (every GRU norm is a layer norm, G = 1) computed
    by the twin's `layer_norm_plain`."""
    monkeypatch.setattr(GroupNormFlexible, "forward",
                        lambda self, x, stat_sum=None: gru_step.layer_norm_plain(
                            x, self.scale, self.bias))


@pytest.mark.parametrize("shape", [(1, 12, 16, 16), (2, 37, 50, 4), (3, 5, 7, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moments_match_float64_numpy(shape, dtype):
    """Each image's mean and variance, two-pass, against numpy's float64
    mean and mean((x - mean)^2) of the same values: within float32's
    rounding of the result (the variance's centre is the float32 mean)."""
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 3 + 1.5).to(dtype)
    mean, var, centered = gru_step.moments_plain(x)
    x64 = x.to(torch.float64).numpy().reshape(shape[0], -1)
    want_mean = x64.mean(axis=1)
    want_var = ((x64 - want_mean[:, None]) ** 2).mean(axis=1)
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (shape[0],)
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=2 ** -23, atol=1e-7)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=2 ** -22)
    assert torch.equal(centered, x.float() - mean.reshape(-1, 1, 1, 1))


@pytest.mark.parametrize("F", [16, 4, 1])
def test_layer_norm_twin_near_group_norm_flexible(F):
    """The twin's layer norm against `GroupNormFlexible` at G = 1 (float32
    means): within one bf16 rounding of the output, since only the
    statistics' sums differ."""
    g = torch.Generator().manual_seed(F)
    x = (torch.randn((2, 30, 40, F), generator=g) * 2 + 0.7).to(torch.bfloat16)
    norm = GroupNormFlexible(F)
    with torch.no_grad():
        norm.scale.copy_(0.5 + torch.rand(F, generator=g))
        norm.bias.copy_(0.2 * torch.randn(F, generator=g))
        want = norm(x).float()
    got = gru_step.layer_norm_plain(x, norm.scale, norm.bias).float()
    assert ((got - want).abs() <= 2 ** -8 * want.abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("wta", [True, False])
@pytest.mark.parametrize("mode", ["normal", "lite"])
def test_fused_step_buffers_equal_the_present_step(mode, wta, twin_norms):
    """The fused step on the CPU (the kernels' twin, the convs' plain
    version) over the planes against `GRUSweep.step` with the same norm:
    after every plane the states, the [x | slot] inputs (the slot h'.bf16,
    the next cell's x h'.bf16, cell 1's x the negated slice), prob_conv's
    input and the reg equal bit for bit; the sweep's regs and carry too."""
    cfg, model = _model(mode)
    sweep = model.gru_sweep
    cost, samples = _cost(cfg, 2, 12, 16)
    C = cfg.feature_channels
    with torch.inference_mode():
        step = port_mvsnet._FusedStep(sweep, cost, wta)
        step.reset()
        states, carry = sweep._zeros(cost)
        carry = carry if wta else None
        for d in range(cfg.max_d):
            torch.neg(cost[:, d], out=step.neg_cost)
            step.depth.copy_(samples[:, d])
            step.body()
            states, reg, carry = sweep.step(states, -cost[:, d], carry, samples[:, d])
            assert all(torch.equal(a, b) for a, b in zip(step.states, states))
            assert torch.equal(step.reg, reg[..., 0])
            if wta:
                assert all(torch.equal(a, b) for a, b in zip(step.carry, carry))
            assert torch.equal(step.inputs[0][..., :C], -cost[:, d])
            for k, s in enumerate(states):
                F = s.shape[-1]
                assert torch.equal(step.inputs[k][..., -F:], s.to(torch.bfloat16))
                nxt = step.inputs[k + 1] if k < 2 else step.prob_in
                assert torch.equal(nxt[..., :F], s.to(torch.bfloat16))
        regs_f, carry_f = step.sweep(cost, samples if wta else None, step.body)
        regs_e, carry_e = sweep.eager(cost, samples if wta else None)
    assert torch.equal(regs_f, regs_e)
    if wta:
        assert all(torch.equal(a, b) for a, b in zip(carry_f, carry_e))
    else:
        assert carry_f is None and carry_e is None


# the fused step against the present step as it is: only the layer norms'
# statistics differ (float64 sums against float32 means), so a normalised
# value near a bf16 rounding tie may round the other way (2^-8 relative)
# and move the states; over 6 planes the regs stay within 1e-2 of
# max(1, max|regs|), the card tests' bf16 tolerance
FUSED_TOL = 1e-2


@pytest.mark.parametrize("mode", ["normal", "lite"])
def test_fused_step_regs_near_the_present_step(mode):
    """The twin's sweep against the present eager sweep (its own
    `GroupNormFlexible`): regs within `FUSED_TOL`, the winner-take-all
    depth equal where the top two regs differ by more than twice that."""
    cfg, model = _model(mode, seed=7)
    sweep = model.gru_sweep
    cost, samples = _cost(cfg, 1, 24, 32, seed=8)
    with torch.inference_mode():
        step = port_mvsnet._FusedStep(sweep, cost, True)
        regs_f, carry_f = step.sweep(cost, samples, step.body)
        regs_e, carry_e = sweep.eager(cost, samples)
    tol = FUSED_TOL * max(1.0, regs_e.abs().max().item())
    assert (regs_f - regs_e).abs().max().item() <= tol
    top2 = regs_e.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1] > 2 * tol)[..., None]
    assert torch.equal(carry_f[1][decided], carry_e[1][decided])


@pytest.mark.parametrize("mode", ["normal", "lite"])
def test_cells_say_what_the_fused_step_computes(mode):
    """`GRURegularizer.fusable`: the bf16 cells of both modes (every norm a
    layer norm over 16, 4, 2 or 8, 2, 1 filters) in bf16, not in float32;
    not a cell whose norm has more than one group; `fused_buffers` holds
    each cell's [x | slot] input, its update and prob_conv's input."""
    from mvsnet_tpu_torch.models.gru import ConvGRUCell

    cfg, model = _model(mode)
    gru = model.gru_sweep.gru
    assert gru.fusable(torch.bfloat16) and not gru.fusable(torch.float32)
    assert len(gru.convs()) == 7 and gru.convs()[-1] is gru.prob_conv
    inputs, updates, prob_in = gru.fused_buffers(2, 5, 7, torch.bfloat16, "cpu")
    f = [c.output_norm.scale.numel() for c in gru.cells]
    assert [t.shape[-1] for t in inputs] == [cfg.feature_channels + f[0], f[0] + f[1],
                                             f[1] + f[2]]
    assert [t.shape for t in updates] == [(2, 5, 7, n) for n in f]
    assert prob_in.shape == (2, 5, 7, f[2]) and prob_in.dtype == torch.bfloat16
    wide = ConvGRUCell(8, 32, dtype=torch.bfloat16)      # G = 2: a group norm
    assert wide.reset_norm.groups == 2 and not wide.fusable(torch.bfloat16)


def test_wrappers_run_the_twin_on_the_cpu():
    """On CPU tensors the three wrappers run their twin and count no
    launches; the sweep does not take the fused step on the CPU."""
    F, B, h, w = 4, 1, 5, 6
    g = torch.Generator().manual_seed(9)
    gates = torch.randn((B, h, w, 2 * F), generator=g).to(torch.bfloat16)
    y = torch.randn((B, h, w, F), generator=g).to(torch.bfloat16)
    state = torch.randn((B, h, w, F), generator=g)
    params = [torch.ones(F), torch.zeros(F)] * 3
    bufs = {}
    before = profiling.counters()["launches.gru_step"]
    for kind, (gates_fn, output_fn, tail_fn) in (
            ("wrapper", (gru_step.gates, gru_step.output, gru_step.tail)),
            ("plain", (gru_step.gates_plain, gru_step.output_plain, gru_step.tail_plain))):
        h_, inp, nxt = state.clone(), torch.zeros((B, h, w, 12), dtype=torch.bfloat16), \
            torch.zeros((B, h, w, F), dtype=torch.bfloat16)
        update, out = torch.empty_like(y), torch.empty((B, h, w))
        gates_fn(gates, h_, inp, update, *params[:4])
        output_fn(y, update, h_, inp, nxt, *params[4:])
        tail_fn(nxt[..., :1], out)
        bufs[kind] = (h_, inp, nxt, update, out)
    assert profiling.counters()["launches.gru_step"] == before
    assert all(torch.equal(a, b) for a, b in zip(*bufs.values()))
    cfg, model = _model("lite")
    with torch.no_grad():
        assert not model.gru_sweep.fuses(_cost(cfg, 1, 4, 4)[0])
