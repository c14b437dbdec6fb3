"""The geometry of the port's depth x space blocks, on one process
(`parallel/mesh.AxisSplit`, `parallel/halo.py`'s index rules,
`models/regnet.plan_volume`, the feature tower's split
`models/feature_net.tower_split`), and the single-process pieces the
blocked paths stand on: the autograd convs at explicit pads against
PyTorch's own autograd, the row-offset warps' plain versions against the
whole ones, the collective tail on one slab, the tower's group norm on row
blocks (`layers.group_norm_sums`) and the images' local halo rows. The
ranks' side is tests/test_torch_parallel.py's.

Tolerances: float32 sums in another order, 1e-5 of the largest entry.
"""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvsnet_tpu_torch.models import feature_net
from mvsnet_tpu_torch.models.layers import group_norm_core
from mvsnet_tpu_torch.models.regnet import plan_volume
from mvsnet_tpu_torch.ops import autograd
from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map, soft_argmin_prob_map_sharded
from mvsnet_tpu_torch.ops.kernels import warp, wgrad
from mvsnet_tpu_torch.parallel import halo
from mvsnet_tpu_torch.parallel.mesh import AxisSplit


def test_row_blocks_follow_the_stride_rule():
    """216 feature rows (1152x864) on two 'space' ranks halve to 108, 54,
    then 27, which splits 14 / 13: a rank owns the outputs whose first
    input it owns."""
    blocks = [[AxisSplit("space", 216, 2, r).bounds(lv) for r in range(2)] for lv in range(4)]
    assert blocks == [[(0, 108), (108, 216)], [(0, 54), (54, 108)], [(0, 27), (27, 54)],
                      [(0, 14), (14, 27)]]
    assert AxisSplit("space", 296, 2, 1).bounds(3) == (19, 37)      # 1600x1184
    assert AxisSplit("depth", 192, 4, 3).bounds(3) == (18, 24)


@pytest.mark.parametrize("size,n,levels,filled", [
    (192, 4, 3, True), (216, 2, 3, True), (24, 2, 3, True),
    (16, 4, 3, False),      # tests/test_torch_parallel.py's fallback: a rank empty at level 3
    (8, 2, 3, False), (16, 2, 3, True)])
def test_filled(size, n, levels, filled):
    assert AxisSplit("depth", size, n, 0).filled(levels) == filled


@pytest.mark.parametrize("size,n", [(24, 2), (216, 2), (296, 2), (192, 4), (48, 4)])
@pytest.mark.parametrize("kind", ["s1", "s2", "up"])
def test_every_read_row_has_an_owner_slot(size, n, kind):
    """Every row a rank's op reads outside its block is another rank's
    first, second or last row, so the one all_gather of those serves it,
    at every level; the backward sends each back to that owner."""
    for level in range(4):
        split = AxisSplit("space", size, n, 0)
        if not split.filled(level):
            continue
        extent = split.extent(level)
        for q in range(n):
            a, b = split.bounds(level, q)
            lo, hi = halo.READS[kind](a, b)
            assert a - 1 <= lo and hi <= b + 2
            for row, k in halo._halo_rows(split, level, kind, q):
                assert 0 <= row < extent and not a <= row < b
                owner, slot = halo._slot(split, level, row)
                oa, ob = split.bounds(level, owner)
                assert oa <= row < ob and row == (oa + slot if slot < 2 else ob - 1)


def test_s2_reads_skip_an_odd_first_row():
    """A block starting at an odd row owns outputs from its second row on:
    its first row is read by the previous rank's last output only."""
    assert halo.READS["s2"](3, 6) == (4, 7)
    assert halo.READS["s2"](0, 3) == (0, 5)        # two rows from the next rank
    assert halo.READS["up"](2, 3) == (1, 3)


@pytest.mark.parametrize("D,h,depth,space,gathered,log", [
    (192, 216, 2, 2, (), None),
    (16, 16, 4, 1, ("depth",), "gathering the volume"),
    (20, 16, 3, 1, (), "do not divide"),
    (32, 16, 1, 4, ("space",), "gathering the volume")])
def test_plan_volume(caplog, D, h, depth, space, gathered, log):
    class FakeMesh:
        def axis_size(self, axis):
            return {"depth": depth, "space": space}[axis]

        def axis_index(self, axis):
            return 0
    with caplog.at_level(logging.WARNING, logger="mvsnet_tpu_torch"):
        plan = plan_volume(FakeMesh(), D, h)
    assert plan.gathered == gathered
    assert (log is None) == (not caplog.records)
    if log:
        assert log in caplog.text
    if D % depth:
        assert plan.depth.n == 1 and plan.depth.bounds() == (0, D)


def _conv_ref(x, k, stride, pads):
    rank = x.ndim - 2
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    xp = F.pad(x.movedim(-1, 1), flat)
    w = k.permute(rank + 1, rank, *range(rank))
    return (F.conv3d if rank == 3 else F.conv2d)(xp, w, stride=stride).movedim(1, -1)


@pytest.mark.parametrize("stride,pads,shape", [
    (1, [(0, 0), (0, 0), (1, 1)], (2, 7, 6, 5, 8)),          # a halo-extended s1 block
    (2, [(0, 0), (0, 0), (0, 1)], (1, 7, 9, 6, 8)),          # an s2 block: 2m + 1 rows
    (2, [(0, 0), (0, 1)], (2, 9, 6, 8)),                     # a 2D s2 block
    (1, [(2, 0), (0, 1)], (2, 6, 7, 8))])
def test_conv_fn_at_explicit_pads_matches_torch_autograd(stride, pads, shape):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((3,) * (len(shape) - 2) + (8, 4)) / 8)
                         .astype(np.float32))
    got = [t.clone().requires_grad_(True) for t in (x, k)]
    want = [t.clone().requires_grad_(True) for t in (x, k)]
    y = autograd.ConvFn.apply(*got, stride, pads)
    y_ref = _conv_ref(*want, stride, pads)
    g = torch.from_numpy(rng.standard_normal(tuple(y_ref.shape)).astype(np.float32))
    (y * g).sum().backward()
    (y_ref * g).sum().backward()
    np.testing.assert_allclose(y.detach(), y_ref.detach(), rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-5 * float(b.grad.abs().max()))


@pytest.mark.parametrize("lo,outs", [((2, 0, 0), (8, 10, 12)), ((1, 2, 0), (7, 7, 12)),
                                     ((1, 0, 0), (6, 10, 12))])
def test_deconv_fn_at_an_explicit_crop_matches_torch_autograd(lo, outs):
    """The halo transposed conv's crop (lo 2 for an even block start, 1 for
    an odd one) forward and backward against `F.conv_transpose3d`'s
    autograd, cropped."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 5, 5, 6, 8)).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((3, 3, 3, 8, 4)) / 8).astype(np.float32))
    got = [t.clone().requires_grad_(True) for t in (x, k)]
    want = [t.clone().requires_grad_(True) for t in (x, k)]
    y = autograd.DeconvFn.apply(*got, lo, outs)
    w = want[1].flip([0, 1, 2]).permute(3, 4, 0, 1, 2)
    full = F.conv_transpose3d(want[0].movedim(-1, 1), w, stride=2)
    y_ref = full[(..., *(slice(a, a + m) for a, m in zip(lo, outs)))].movedim(1, -1)
    g = torch.from_numpy(rng.standard_normal(tuple(y_ref.shape)).astype(np.float32))
    (y * g).sum().backward()
    (y_ref * g).sum().backward()
    np.testing.assert_allclose(y.detach(), y_ref.detach(), rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-5 * float(b.grad.abs().max()))


def test_wgrad_checks_explicit_pads():
    x, g = torch.zeros(1, 9, 6, 4), torch.zeros(1, 7, 6, 2)
    assert wgrad.wgrad(x, g, (3, 3), 1, pads=[(0, 0), (1, 1)]).shape == (3, 3, 4, 2)
    with pytest.raises(ValueError, match="stride-1 output"):
        wgrad.wgrad(x, g, (3, 3), 1)


def _homs(D):
    h = np.tile(np.eye(3, dtype=np.float32), (D, 1, 1))
    for d in range(D):
        h[d] = [[1.0, -0.02, 3.0 * d - 4.0], [0.02, 1.0, 0.5 * d], [1e-4, -5e-5, 1.0]]
    return torch.from_numpy(h)


def test_row_offset_warps_stitch_to_the_whole_map():
    """The row blocks of the plain K2 stitch to the whole warp exactly, and
    the plain K3's blocks add up to the whole adjoint."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.standard_normal((14, 18, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((5, 14, 18, 8)).astype(np.float32))
    homs = _homs(5)
    blocks = [(0, 6), (6, 5), (11, 3)]
    whole = warp.warp_all_depths(img, homs)
    assert torch.equal(torch.cat([warp.warp_all_depths(img, homs, r, n) for r, n in blocks],
                                 dim=1), whole)
    parts = sum(warp.warp_transpose(g[:, r:r + n], homs, r, 14) for r, n in blocks)
    np.testing.assert_allclose(parts, warp.warp_transpose(g, homs), rtol=1e-5, atol=1e-5)
    plan, plan_rows = warp.transpose_plan(homs, 14, 18), warp.transpose_plan(homs, 6, 18, 6)
    assert torch.equal(plan[0], plan_rows[0])
    with pytest.raises(ValueError, match="do not fit"):
        warp.warp_all_depths(img, homs, 10, 5)


@pytest.mark.parametrize("buckets,inverse", [(2, False), (4, False), (4, True)])
def test_tail_on_one_slab_is_the_whole_tail(buckets, inverse):
    rng = np.random.default_rng(4)
    reg = torch.from_numpy(rng.standard_normal((2, 12, 5, 6)).astype(np.float32) * 3)
    ds, di = torch.tensor([5.0, 4.0]), torch.tensor([0.5, 0.25])
    de = ds + 11 * di
    want = soft_argmin_prob_map(reg, ds, di, 12, inverse, de, buckets)
    got = soft_argmin_prob_map_sharded(reg, 0, ds, di, 12, inverse, de, buckets)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="do not fit"):
        soft_argmin_prob_map_sharded(reg, 4, ds, di, 12, inverse, de, buckets)


def test_five_by_five_stride_two_reads():
    """conv9_0 and conv10_0 (5x5, stride 2, TF pads 1 / 2 at even extent):
    output o reads rows 2o-1 .. 2o+3, so a block [a, b) reads one row from
    the previous rank (a even; none for an odd a) and two (b even) or three
    (b odd) from the next."""
    assert halo.READS["s2k5"](12, 24) == (11, 26)
    assert halo.READS["s2k5"](0, 12) == (-1, 14)
    assert halo.READS["s2k5"](3, 6) == (3, 8)
    assert halo.READS["s2k5"](0, 3) == (-1, 6)
    split = AxisSplit("space", 40, 2, 0)
    assert halo._halo_rows(split, 2, "s2k5", 0) == [(5, 1), (6, 2), (7, 3)]
    assert [halo._slot(split, 2, r) for r in (5, 6, 7)] == [(1, 0), (1, 1), (1, 3)]
    assert halo._halo_rows(split, 2, "s2k5", 1) == []         # an odd start: none
    assert halo._halo_rows(AxisSplit("space", 48, 2, 1), 2, "s2k5", 1) == [(5, 0)]
    assert halo._packets(split, 2, "s2k5") == ([0, 1, 3], [1, 2, 3])


@pytest.mark.parametrize("size,n", [(24, 2), (40, 2), (216, 2), (296, 2), (48, 4)])
def test_five_by_five_reads_have_owner_slots(size, n):
    """Every row a rank's 5x5 stride-2 op reads outside its block is
    another rank's first, second, third or last row (slots 0, 1, 3, 2),
    at the feature tower's levels 0 and 1 (the feature rows' split seen two
    levels finer)."""
    tower = AxisSplit("space", size, n, 0).finer(2)
    for level in (0, 1):
        for q in range(n):
            a, b = tower.bounds(level, q)
            for row, _ in halo._halo_rows(tower, level, "s2k5", q):
                owner, slot = halo._slot(tower, level, row)
                oa, ob = tower.bounds(level, owner)
                assert oa <= row < ob and not a <= row < b
                assert row == {0: oa, 1: oa + 1, 2: ob - 1, 3: oa + 2}[slot]


def test_tower_split_is_four_times_the_volume_rows():
    """The tower's split of 864 image rows over two 'space' ranks: level 2
    is the volume's 216 feature rows split 108 / 108, levels 0 and 1 four
    and two times their starts, levels 3 and 4 by the stride rule (uneven
    at level 5 of the volume's own split: 27 -> 14 / 13)."""
    rows = AxisSplit("space", 216, 2, 1)
    tower = rows.finer(2)
    assert [tower.bounds(lv) for lv in range(5)] == [(432, 864), (216, 432), (108, 216),
                                                    (54, 108), (27, 54)]
    assert [tower.extent(lv) for lv in range(5)] == [864, 432, 216, 108, 54]
    assert tower.bounds(2) == rows.bounds(0) and tower.bounds(4) == rows.bounds(2)
    assert AxisSplit("space", 216, 2, 0).finer(2).bounds(5) == (0, 14)


class _SpaceMesh:
    def __init__(self, space):
        self.space = space

    def axis_size(self, axis):
        return {"data": 1, "depth": 1, "space": self.space}[axis]

    def axis_index(self, axis):
        return 0


@pytest.mark.parametrize("H,space,rows_n,split,log", [
    (864, 2, 2, True, None),
    (96, 2, 2, True, None),
    (64, 4, 4, True, None),          # level 4: one row a rank
    (32, 4, 4, False, "fewer rows than a halo reads"),
    (64, 2, 1, False, "do not split"),
    (64, 1, 1, False, None)])        # no 'space' axis: whole, as JAX
def test_tower_split_or_whole(caplog, H, space, rows_n, split, log):
    rows = AxisSplit("space", H // 4, rows_n, 0)
    with caplog.at_level(logging.WARNING, logger="mvsnet_tpu_torch"):
        got = feature_net.tower_split(_SpaceMesh(space), rows, H)
    assert (got is not None) == split
    assert (log is None) == (not caplog.records)
    if log:
        assert log in caplog.text and "UNetDS2GN" in caplog.text
    if split:
        assert got.bounds(2) == rows.bounds(0)


def test_local_rows_are_the_rows_an_op_reads():
    """The images' rows a rank's first convs read, cut locally: zeros
    beyond the ends, as an exchange would give a block of them."""
    x = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    for q in (0, 1):
        split = AxisSplit("space", 4, 2, q).finer(2)
        for kind in ("s1", "s2"):
            lo, hi = halo.READS[kind](*split.bounds(0))
            padded = F.pad(x, (0, 0, 1, 1))
            np.testing.assert_array_equal(halo.local_rows(x, 1, split, 0, kind),
                                          padded[:, lo + 1:hi + 1])
    with pytest.raises(ValueError, match="whole"):
        halo.local_rows(x[:, :8], 1, AxisSplit("space", 4, 2, 0).finer(2), 0, "s1")


def test_halo_conv_takes_the_towers_kernels_only():
    split = AxisSplit("space", 5, 2, 0).finer(1)        # 10 rows, then 5
    x, k5 = torch.zeros(1, 10, 4, 2), torch.zeros(5, 5, 2, 2)
    with pytest.raises(ValueError, match="5x5"):
        halo.halo_conv(x, k5, None, 1, False, mesh=None, splits=(split, None), level=0,
                       replicated=True)
    with pytest.raises(ValueError, match="even extent"):
        halo.halo_conv(x[:, :5], k5, None, 2, False, mesh=None, splits=(split, None),
                       level=1, replicated=True)
    assert halo.halo_conv(x, k5, None, 2, False, mesh=None, splits=(split, None), level=0,
                          replicated=True).shape == (1, 2, 2, 2)


@pytest.mark.parametrize("blocks", [[(0, 5), (5, 12)], [(0, 3), (3, 7), (7, 12)]])
def test_group_norm_on_row_blocks_is_the_whole_norm(blocks):
    """The tower's group norm on row blocks (`group_norm_core`'s
    `stat_sum`): each of its two passes sums over every block, so each
    block's output is its rows of the whole map's norm within float32's
    reordered sums (1e-6), and the sum of the blocks' losses, with the
    sums differentiable, backpropagates to the whole's gradient within 1e-5
    of its largest entry (the sums' backward is the ranks'). Each block
    calls `stat_sum` twice: two collectives a norm."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((2, 12, 9, 16)) * 2 + 1).astype(np.float32))
    gamma = torch.from_numpy((0.5 + rng.random(16)).astype(np.float32))
    beta = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    whole_x = x.clone().requires_grad_(True)
    whole = group_norm_core(whole_x, gamma, beta, 2, 1e-5)
    (whole * cot).sum().backward()

    blocks_x = x.clone().requires_grad_(True)
    views = [blocks_x[:, a:b] for a, b in blocks]

    def pass_sums(v, mean):
        """A block's local sums of one pass (the mean's, or the squares'
        about `mean`) and its count, as `spatial_mean` forms them."""
        t = v if mean is None else torch.square(v - mean)
        return torch.cat([t.sum(dim=(1, 2)).reshape(-1), t.new_tensor([v.shape[1] * v.shape[2]])])

    # the whole map's group mean, from every block: the first pass's result
    total = sum(pass_sums(v, None) for v in views)
    mean_c = (total[:-1] / total[-1]).reshape(2, 2, 8).mean(dim=2, keepdim=True)
    mean = mean_c.expand(2, 2, 8).reshape(2, 1, 1, 16)
    parts = []
    for i, v in enumerate(views):
        calls = []

        def stat_sum(t, i=i, calls=calls):
            others = [pass_sums(w, mean if calls else None) for j, w in enumerate(views) if j != i]
            calls.append(t)
            return t + sum(others)
        parts.append(group_norm_core(v, gamma, beta, 2, 1e-5, stat_sum=stat_sum))
        assert len(calls) == 2
    y = torch.cat(parts, dim=1)
    np.testing.assert_allclose(y.detach(), whole.detach(), rtol=1e-6, atol=1e-6)
    (y * cot).sum().backward()
    np.testing.assert_allclose(blocks_x.grad, whole_x.grad, rtol=1e-5,
                               atol=1e-5 * float(whole_x.grad.abs().max()))


def test_half_precision_group_norm_on_row_blocks_is_bit_equal():
    """In bfloat16 the norm's statistics are float64 sums of x and x^2, one
    sum over the blocks: the blocks' outputs equal the whole map's bit for
    bit (the order of the sums does not show), and the whole map's is the
    float32 norm's within half a bfloat16 rounding of its values."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((2, 12, 9, 16)) * 2 + 1).astype(np.float32))
    x = x.to(torch.bfloat16)
    gamma = torch.from_numpy((0.5 + rng.random(16)).astype(np.float32))
    beta = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    whole = group_norm_core(x, gamma, beta, 2, 1e-5)
    ref = group_norm_core(x.float(), gamma, beta, 2, 1e-5)
    np.testing.assert_allclose(whole.float(), ref, rtol=2 ** -8, atol=2 ** -8)
    blocks = [(0, 3), (3, 7), (7, 12)]

    def sums(v):
        vf = v.float()
        s = torch.stack([vf.sum(dim=(1, 2), dtype=torch.float64),
                         (vf * vf).sum(dim=(1, 2), dtype=torch.float64)])
        return torch.cat([s.reshape(-1), s.new_tensor([v.shape[1] * v.shape[2]])])
    parts = []
    for i, (a, b) in enumerate(blocks):
        calls = []

        def stat_sum(t, i=i, calls=calls):
            calls.append(t)
            return t + sum(sums(x[:, c:d]) for j, (c, d) in enumerate(blocks) if j != i)
        parts.append(group_norm_core(x[:, a:b], gamma, beta, 2, 1e-5, stat_sum=stat_sum))
        assert len(calls) == 1                  # one collective a norm
    assert torch.equal(torch.cat(parts, dim=1), whole)
