"""`layers.group_norm_core`'s half-precision path on the CPU, the plain
pair of `ops/kernels/norm.py`, at the tower's five level widths (at 1/32
of DTU's 1600x1184, N=5 views): the pair's two steps, the sums and then
the normalisation, are the norm; the ReLU handed to it is the ReLU after
it; row blocks whose sums are added between the steps give the whole
map's norm bit for bit; what the kernels do not take (CPU tensors,
float32 maps, calls that record gradients) stays on the plain path
without a launch. The kernels themselves run in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from mvsnet_tpu_torch.models.layers import ConvGN, DeconvGN, group_norm_core, reset_parameters
from mvsnet_tpu_torch.ops.kernels import norm
from mvsnet_tpu_torch.utils import profiling

# UNetDS2GN's levels at 1600x1184 cut 32-fold: (rows, columns, channels);
# G = C / 8 groups at every level
LEVELS = [(-(-37 // 2 ** lv), -(-50 // 2 ** lv), 8 * 2 ** lv) for lv in range(5)]


def _map(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((0.5 + rng.random(C)).astype(np.float32))
    beta = torch.from_numpy(rng.standard_normal(C).astype(np.float32))
    return x, gamma, beta


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("level", range(5))
def test_plain_pair_equals_group_norm_core(level, dtype, relu):
    """`group_norm_core` on a half-precision CPU map is the plain pair, the
    sums over the map's pixels and then the normalisation; the ReLU handed
    to it is the ReLU after the norm."""
    h, w, C = LEVELS[level]
    x, gamma, beta = _map(level, (5, h, w, C), dtype)
    want = group_norm_core(x, gamma, beta, C // 8, 1e-5, relu=relu)
    sums = norm.group_norm_stats_plain(x)
    assert sums.shape == (2, 5, C) and sums.dtype == torch.float64
    got = norm.group_norm_apply_plain(x, sums, h * w, gamma, beta, C // 8, 1e-5, relu)
    assert got.dtype == dtype and torch.equal(got, want)
    if relu:
        plain = group_norm_core(x, gamma, beta, C // 8, 1e-5)
        assert torch.equal(want, torch.relu(plain)) and (want == 0).any()


@pytest.mark.parametrize("level", range(5))
def test_plain_pair_on_row_blocks_equals_the_whole_map(level):
    """Each block's sums, plus the other blocks' added by `stat_sum` with
    the count, then its normalisation: the blocks stitch to the whole
    map's norm bit for bit, one `stat_sum` call a block."""
    h, w, C = LEVELS[level]
    x, gamma, beta = _map(10 + level, (5, h, w, C), torch.bfloat16)
    whole = group_norm_core(x, gamma, beta, C // 8, 1e-5, relu=True)
    cuts = [0, h // 3, h - h // 4, h]
    blocks = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]

    def sums(v):
        s = norm.group_norm_stats_plain(v)
        return torch.cat([s.reshape(-1), s.new_tensor([v.shape[1] * v.shape[2]])])
    parts = []
    for i, (a, b) in enumerate(blocks):
        calls = []

        def stat_sum(t, i=i, calls=calls):
            calls.append(t)
            return t + sum(sums(x[:, c:d]) for j, (c, d) in enumerate(blocks) if j != i)
        parts.append(group_norm_core(x[:, a:b], gamma, beta, C // 8, 1e-5, relu=True,
                                     stat_sum=stat_sum))
        assert len(calls) == 1
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("case", ["cpu_half", "float32", "records_grad"])
def test_plain_path_without_launches(case, monkeypatch):
    """CPU tensors, float32 maps and calls that record gradients take
    `group_norm_core`'s plain code: the kernels' wrapper is never called
    and the counter does not move; ConvGN's and DeconvGN's ReLU, handed to
    the norm, is the ReLU after it."""
    called = []
    monkeypatch.setattr(norm, "group_norm", lambda *a, **k: called.append(a))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    x, gamma, beta = _map(20, (2, 9, 11, 16), dtype)
    if case == "records_grad":
        gamma.requires_grad_()
    before = profiling.counters()["launches.group_norm"]
    y = group_norm_core(x, gamma, beta, 2, 1e-5, relu=True)
    assert y.dtype == dtype and (y.grad_fn is not None) == (case == "records_grad")
    for layer in (ConvGN(16, 8, 3, 1, dtype=dtype), DeconvGN(16, 8, relu=True, dtype=dtype)):
        reset_parameters(layer.eval(), 21)
        with torch.no_grad():
            layer.gn.bias.copy_(torch.linspace(-1.0, 1.0, 8))
            inner = layer.conv if isinstance(layer, ConvGN) else layer.deconv
            want = torch.relu(layer.gn(inner(x)))
            assert torch.equal(layer(x), want) and (want == 0).any()
    assert not called and profiling.counters()["launches.group_norm"] == before
