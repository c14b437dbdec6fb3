"""Convs on blocks of a volume with halo exchanges: the U-Net sharding that
GSPMD derives in the JAX package (models/mvsnet.py:174, models/regnet.py:10),
the row halos of the ConvGRU's cells (:228) and of the 2D feature tower
(whose output JAX constrains over 'space', :113-114), written out.

A rank holds a block of the volume: along each split axis (depth planes
over 'depth', feature rows over 'space'; columns and channels whole) the
[start, stop) of its `AxisSplit` at the op's level, the levels halving by
the stride rule, so blocks may be uneven. Zeros stand beyond the global
ends. From the kernels' index rules, on an input block [a, b):

  * stride-1 SAME conv (pads 1/1): output o reads o-1..o+1, so the rows
    a-1 and b, one from each neighbour, then pads (0, 0): b - a outputs;
  * stride-2 SAME conv (pads 0/1, even extent): output o reads 2o..2o+2,
    and the rank owns the outputs [ceil(a/2), ceil(b/2)) whose first input
    it owns, so it reads rows 2 ceil(a/2) .. 2 ceil(b/2): one or two rows
    from the next rank, and an odd a leaves its own first row unread;
  * 5x5 stride-2 SAME conv (TF pads 1/2 at even extent, the tower's
    conv9_0 and conv10_0): output o reads 2o-1..2o+3, so the outputs
    [ceil(a/2), ceil(b/2)) read rows 2 ceil(a/2) - 1 .. 2 ceil(b/2) + 2:
    one row from the previous rank (a even; none when a is odd), two (b
    even) or three (b odd) from the next;
  * stride-2 transposed conv, out[o] = sum_t k[2-t] x[(o-t)/2]: output o
    reads x[o//2] and x[o//2 - 1], so the fine block [a, b) whose coarse
    block is [ceil(a/2), ceil(b/2)) reads one row from the previous rank,
    prepended, then `deconv(lo=a - 2 ceil(a/2) + 2)` over b - a outputs.

A 3x3x3 conv on a depth x space block needs its corners too: it exchanges
over 'depth' first, then the rows of the depth-extended block over
'space'. One `all_gather` over the axis group serves each exchange: every
rank sends those of its first, second, third and last rows that some
rank's index rule reads (every rank computes which from the blocks, so the
packets agree: s1 sends two rows, the transposed conv one, s2 one or two,
the 5x5 s2 conv two to four), and each takes what it reads; deadlock-free,
and the same on gloo and NCCL. The exchange is an autograd function: its backward sends each halo
row's gradient back to its owner in one `all_gather` too, which adds it to
its boundary row, so the ops train (`ops/autograd.py` at explicit pads).
An axis of one rank takes the kernel's SAME pads instead. An input that
every rank holds whole (`replicated`: the tower's images) is cut to the
rows its op reads, zeros beyond the ends, with no exchange. `fits` says
whether a split serves a list of ops: every row a rank reads beyond its
block lies in a neighbour's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mvsnet_tpu_torch.ops import autograd
from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import deconv as deconv_k
from mvsnet_tpu_torch.parallel.mesh import AxisSplit, Mesh


def _half_up(a: int) -> int:
    return -(-a // 2)


# the input rows [lo, hi) an op reads, from the input block [a, b)
READS = {
    "s1": lambda a, b: (a - 1, b + 1),
    "s2": lambda a, b: (2 * _half_up(a), 2 * _half_up(b) + 1),
    "s2k5": lambda a, b: (2 * _half_up(a) - 1, 2 * _half_up(b) + 2),
    "up": lambda a, b: (a - 1, b),
}
# the kind of a (kernel size, stride) conv
CONV_KINDS = {(3, 1): "s1", (3, 2): "s2", (5, 2): "s2k5"}


def _owner(split: AxisSplit, level: int, row: int) -> int:
    for q in range(split.n):
        a, b = split.bounds(level, q)
        if a <= row < b:
            return q
    raise ValueError(f"row {row} lies outside {split}")


def _slot(split: AxisSplit, level: int, row: int):
    """(owner, slot) of a row another rank reads: slot 0 or 1 its owner's
    first or second row, 2 its last, 3 its third."""
    q = _owner(split, level, row)
    a, b = split.bounds(level, q)
    if row - a < 2:
        return q, row - a
    if row == b - 1:
        return q, 2
    if row - a == 2:
        return q, 3
    raise ValueError(f"row {row} is not at an edge of rank {q}'s block [{a}, {b})")


def _halo_rows(split: AxisSplit, level: int, kind: str, q: int):
    """The rows rank q reads from other ranks: [(row, k)], k its place among
    (row a - 1, row b, row b + 1, row b + 2)."""
    a, b = split.bounds(level, q)
    lo, hi = READS[kind](a, b)
    n = split.extent(level)
    rows = [(a - 1, 0), (b, 1), (b + 1, 2), (b + 2, 3)]
    return [(r, k) for r, k in rows if lo <= r < hi and 0 <= r < n and not a <= r < b]


def _packets(split: AxisSplit, level: int, kind: str):
    """(slots, places): the owner slots (0, 1: first, second row; 2: last;
    3: third) that some rank reads, the forward packet's rows in that order; and the
    places k of `_halo_rows` that some rank reads, the backward packet's.
    The same on every rank."""
    reads = [r for q in range(split.n) for r in _halo_rows(split, level, kind, q)]
    slots = sorted({_slot(split, level, row)[1] for row, _ in reads})
    places = sorted({k for _, k in reads})
    return slots, places


class _Exchange(torch.autograd.Function):
    """x's block along `dim`, extended to the rows [lo, hi) its op reads;
    see the module docstring."""

    @staticmethod
    def forward(ctx, x, mesh, dim, split, level, kind):
        ctx.mesh, ctx.dim, ctx.split, ctx.level, ctx.kind = mesh, dim, split, level, kind
        a, b = split.bounds(level)
        lo, hi = READS[kind](a, b)
        n_rows = x.shape[dim]
        if n_rows != b - a:
            raise ValueError(f"a block of {n_rows} rows along dim {dim}, expected [{a}, {b}) "
                             f"of {split} at level {level}")
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        slots, _ = _packets(split, level, kind)
        every = None
        if slots:
            rows = {0: x.narrow(dim, 0, 1), 1: x.narrow(dim, 1, 1) if n_rows > 1 else zero,
                    2: x.narrow(dim, n_rows - 1, 1),
                    3: x.narrow(dim, 2, 1) if n_rows > 2 else zero}
            packet = torch.cat([rows[k] for k in slots], dim)
            every = mesh.all_gather(packet.unsqueeze(0), split.axis, dim=0)
        extent = split.extent(level)

        def halo_row(row):
            if not 0 <= row < extent:
                return zero
            q, k = _slot(split, level, row)
            return every[q].narrow(dim, slots.index(k), 1)
        own0, own1 = max(lo, a), min(hi, b)
        parts = [halo_row(row) for row in range(lo, min(hi, a))]
        parts.append(x.narrow(dim, own0 - a, own1 - own0))
        parts += [halo_row(row) for row in range(max(lo, b), hi)]
        ctx.own = (own0 - a, own1 - own0, n_rows, lo)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, split, level, kind = ctx.mesh, ctx.dim, ctx.split, ctx.level, ctx.kind
        start, count, n_rows, lo = ctx.own
        a, b = split.bounds(level)
        grad = torch.zeros(g.shape[:dim] + (n_rows,) + g.shape[dim + 1:], dtype=g.dtype,
                           device=g.device)
        grad.narrow(dim, start, count).copy_(g.narrow(dim, a + start - lo, count))
        _, places = _packets(split, level, kind)
        if places:
            zero = torch.zeros_like(g.narrow(dim, 0, 1))
            packet = {k: zero for k in places}
            for row, k in _halo_rows(split, level, kind, split.index):
                packet[k] = g.narrow(dim, row - lo, 1)
            every = mesh.all_gather(torch.cat([packet[k] for k in places], dim).unsqueeze(0),
                                    split.axis, dim=0)
            for q in range(split.n):
                if q == split.index:
                    continue
                for row, k in _halo_rows(split, level, kind, q):
                    if a <= row < b:
                        grad.narrow(dim, row - a, 1).add_(
                            every[q].narrow(dim, places.index(k), 1))
        return grad, None, None, None, None, None


def exchange(x, mesh: Mesh, dim: int, split: AxisSplit, level: int, kind: str):
    """x (a block of `split` at `level` along `dim`) extended to the rows
    its op `kind` ("s1", "s2", "s2k5" or "up") reads; differentiable."""
    return _Exchange.apply(x, mesh, dim, split, level, kind)


def local_rows(x, dim: int, split: AxisSplit, level: int, kind: str):
    """x, whole along `dim` on every rank, cut to the rows [lo, hi) that
    this rank's op `kind` reads at `level`, zeros beyond the ends: what
    `exchange` gives a block of it, without a collective."""
    lo, hi = READS[kind](*split.bounds(level))
    n = x.shape[dim]
    if n != split.extent(level):
        raise ValueError(f"{n} rows along dim {dim}, expected the whole {split.extent(level)}")
    zeros = [torch.zeros_like(x.narrow(dim, 0, 1))]
    parts = zeros * max(0, -lo) + [x.narrow(dim, max(lo, 0), min(hi, n) - max(lo, 0))]
    return torch.cat(parts + zeros * max(0, hi - n), dim)


def fits(split: AxisSplit, ops) -> bool:
    """Whether `split` serves the ops [(kind, level)]: at each op's level
    every rank holds a row, and every row a rank reads beyond its block
    lies in a neighbour's."""
    for kind, level in ops:
        if not split.filled(level):
            return False
        for q in range(split.n):
            for row, _ in _halo_rows(split, level, kind, q):
                if abs(_owner(split, level, row) - q) != 1:
                    return False
    return True


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def halo_conv(x, kernel, bias, stride: int, relu: bool, *, mesh: Mesh,
              splits: Sequence[Optional[AxisSplit]], level: int, replicated: bool = False):
    """This rank's block of conv(whole volume, kernel, bias, stride, relu)
    for a SAME conv, 3x3(x3) of stride 1 or 2 or 5x5 of stride 2, on x
    (B, [D,] H, W, C), a block at `level` of `splits` (one per spatial
    axis, None or one rank: whole), or with `replicated` whole on every
    rank; see the module docstring. Under autograd (bias None, no ReLU:
    the training layers add them) it is `ConvFn` at the explicit pads."""
    K = kernel.shape[0]
    kind = CONV_KINDS.get((K, stride))
    if kind is None or tuple(kernel.shape[:-2]) != (K,) * (x.ndim - 2):
        raise ValueError(f"halo_conv takes 3x3(x3) kernels of stride 1 or 2 and 5x5(x5) of "
                         f"stride 2, got {tuple(kernel.shape)} at stride {stride}")
    xx, pads = x, []
    for dim, split in enumerate(splits, start=1):
        if split is not None and split.n > 1:
            if stride == 2 and split.extent(level) % 2:
                raise ValueError(f"a stride-2 halo conv reads TF's SAME pads of an even "
                                 f"extent, got {split.extent(level)} along dim {dim}")
            xx = (local_rows(xx, dim, split, level, kind) if replicated else
                  exchange(xx, mesh, dim, split, level, kind))
            pads.append((0, 0))
        else:
            pads.append(conv_k.same_pads(x.shape[dim], K, stride)[:2])
    if _needs_grad(xx, kernel):
        if bias is not None or relu:
            raise ValueError("a differentiable halo conv takes no bias or ReLU")
        return autograd.ConvFn.apply(xx, kernel, stride, pads)
    return conv_k.conv(xx, kernel, bias, stride, relu, pads=pads)


def halo_deconv(x, kernel, bias, relu: bool, *, mesh: Mesh,
                splits: Sequence[Optional[AxisSplit]], level: int):
    """This rank's block at level - 1 of flax's k3 s2 SAME transposed conv
    of the whole volume, x a block at `level`; see the module docstring.
    Under autograd it is `DeconvFn` at the explicit crop."""
    xx, los, outs = x, [], []
    for dim, split in enumerate(splits, start=1):
        if split is not None and split.n > 1:
            xx = exchange(xx, mesh, dim, split, level, "up")
            a, b = split.bounds(level - 1)
            los.append(a - 2 * split.bounds(level)[0] + 2)
            outs.append(b - a)
        else:
            los.append(0)
            outs.append(2 * x.shape[dim])
    if _needs_grad(xx, kernel):
        if bias is not None or relu:
            raise ValueError("a differentiable halo deconv takes no bias or ReLU")
        return autograd.DeconvFn.apply(xx, kernel, tuple(los), tuple(outs))
    return deconv_k.deconv(xx, kernel, bias, relu, lo=los, out_spatial=outs)
