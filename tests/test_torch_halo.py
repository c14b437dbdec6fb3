"""The geometry of the port's depth x space blocks, on one process
(`parallel/mesh.AxisSplit`, `parallel/halo.py`'s index rules,
`models/regnet.plan_volume`), and the single-process pieces the blocked
paths stand on: the autograd convs at explicit pads against PyTorch's own
autograd, the row-offset warps' plain versions against the whole ones,
and the collective tail on one slab. The ranks' side is
tests/test_torch_parallel.py's.

Tolerances: float32 sums in another order, 1e-5 of the largest entry.
"""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
