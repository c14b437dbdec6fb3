"""The ('data', 'depth', 'space') process mesh (counterpart of
mvsnet_tpu/parallel/mesh.py).

One process runs per card over `torch.distributed`. A mesh is the process
group, this rank's coordinates, one subgroup per axis and the rank's
device. Coordinates are rank-major in (data, depth, space), the order in
which JAX's batch spec P(("data", "depth", "space")) lays maps out.

Backends:
  * "nccl": one rank per card, device cuda:LOCAL_RANK;
  * "gloo": CPU tensors, device cpu (the tests);
  * "gloo-cuda": ranks on cards, collectives staged through host memory
    (bfloat16 moved as its bytes), device cuda:(LOCAL_RANK mod the card
    count). NCCL cannot put two ranks on one card; this can, so one card
    can run a two-rank mesh.

The collectives the port uses are `all_gather` and `all_reduce` (sum, or
max) along one axis or the whole mesh, and `broadcast_` from rank 0
(`shard_state`). Three of them have a backward for training over blocks:
  * `all_reduce_grad`: the sum, whose backward sums the cotangents over the
    same ranks (every rank's loss depends on every rank's part);
  * `all_reduce_replicated`: the sum, whose backward is the identity (what
    follows it runs alike on every rank of the axis and the loss is taken
    once: the soft-argmin tail over 'depth');
  * `all_gather_grad`: the gather, whose backward gives each rank its own
    part of the cotangent, summed over the axis (partial consumers: the
    source views of the cost volume) or as it is (`replicated`: the maps
    after the tail, whose loss every rank of the axis takes whole).
The boundary exchanges of the blocked U-Net and of the GRU's cells are one
`all_gather` over an axis each (`parallel/halo.py`). `AxisSplit` says which
planes or rows of a volume axis a rank holds, level by level.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "depth", "space")
BACKENDS = ("nccl", "gloo", "gloo-cuda")


def factorize_devices(n: int) -> Tuple[int, int, int]:
    """Split n devices over (data, depth, space), preferring data, then
    depth (a copy of mvsnet_tpu/parallel/mesh.py:19-42). Powers of two
    factor cleanly (8 -> (2, 2, 2)); odd counts degrade to pure data
    parallelism on the residual factor."""
    def largest_pow2(x):
        p = 1
        while x % 2 == 0 and x > 1:
            x //= 2
            p *= 2
        return p

    p2 = largest_pow2(n)
    rest = n // p2
    dims = [1, 1, 1]
    i = 0
    while p2 > 1:
        dims[i % 3] *= 2
        p2 //= 2
        i += 1
    dims[0] *= rest
    return tuple(dims)


def rank_coords(rank: int, shape) -> Tuple[int, int, int]:
    """(data, depth, space) coordinates of `rank`, rank-major."""
    data, rest = divmod(rank, shape[1] * shape[2])
    depth, space = divmod(rest, shape[2])
    return data, depth, space


def axis_ranks(shape, axis: int):
    """The rank lists along `axis`, one per setting of the other two axes,
    in a fixed order; each list in axis order."""
    others = [range(s) if i != axis else range(1) for i, s in enumerate(shape)]
    out = []
    for fixed in itertools.product(*others):
        ranks = []
        for k in range(shape[axis]):
            c = list(fixed)
            c[axis] = k
            ranks.append((c[0] * shape[1] + c[1]) * shape[2] + c[2])
        out.append(ranks)
    return out


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class AxisSplit:
    """How one axis of a volume lies over a mesh axis: `size` planes or
    rows at level 0, split evenly over `n` ranks (1: whole on every rank),
    this rank the `index`-th. Level l halves level l - 1 by the stride
    rule of a stride-2 SAME conv: a rank owns the outputs whose first input
    it owns, so its block is [ceil(start / 2^l), ceil(stop / 2^l)), and the
    blocks may be uneven (216 rows on 2 ranks: 108, 54, 27 -> 14 / 13).

    `shift` levels finer (`finer`), level `shift` is the split's level 0
    and the levels below it double: the feature tower's image rows, whose
    level 2 is the cost volume's rows, start at 4x the volume's starts."""

    axis: str
    size: int
    n: int = 1
    index: int = 0
    shift: int = 0

    def bounds(self, level: int = 0, index: Optional[int] = None) -> Tuple[int, int]:
        """[start, stop) of rank `index` (default this rank) at `level`."""
        i = self.index if index is None else index
        a, b = i * self.size // self.n, (i + 1) * self.size // self.n
        lv = level - self.shift
        if lv < 0:
            return a << -lv, b << -lv
        return _ceil_div(a, 2 ** lv), _ceil_div(b, 2 ** lv)

    def extent(self, level: int = 0) -> int:
        """The whole axis at `level`."""
        lv = level - self.shift
        return self.size << -lv if lv < 0 else _ceil_div(self.size, 2 ** lv)

    def finer(self, levels: int) -> "AxisSplit":
        """The same split seen `levels` stride-2 levels finer: its level
        `levels` is this split's level 0."""
        return dataclasses.replace(self, shift=self.shift + levels)

    def filled(self, levels: int) -> bool:
        """Whether every rank holds at least one plane or row at levels
        0..levels."""
        return all(a < b for lv in range(levels + 1)
                   for a, b in (self.bounds(lv, i) for i in range(self.n)))


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis whose backward sums the cotangents over the same
    axis: every rank's loss depends on every rank's input through it."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axis), None, None


class _AllReduceReplicated(torch.autograd.Function):
    """Sum over an axis whose backward is the identity: the ranks of the
    axis use the sum alike and the loss counts it once, so each rank's
    cotangent of the sum is already the whole one."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    """`all_gather` along `dim` whose backward hands each rank its own part
    of the cotangent: summed over the axis first, unless `replicated`."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, replicated):
        ctx.mesh, ctx.axis, ctx.dim, ctx.replicated = mesh, axis, dim, replicated
        ctx.part = t.shape[dim]
        return mesh.all_gather(t.contiguous(), axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            g = ctx.mesh.all_reduce(g.contiguous(), ctx.axis)
        i = ctx.mesh.axis_index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.part, ctx.part), None, None, None, None


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, depth, space) mesh of processes; see the module docstring.
    `groups` maps each axis of size > 1 to its subgroup and None to the
    whole mesh; a size-1 mesh has none."""

    shape: Tuple[int, int, int]
    rank: int
    backend: Optional[str]
    device: torch.device
    groups: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> Tuple[int, int, int]:
        return rank_coords(self.rank, self.shape)

    def axis_size(self, axis: Optional[str]) -> int:
        return self.size if axis is None else self.shape[AXES.index(axis)]

    def axis_index(self, axis: Optional[str]) -> int:
        return self.rank if axis is None else self.coords[AXES.index(axis)]

    def _to_group(self, t, as_bytes: bool):
        """The tensor handed to the process group: `t` itself on NCCL and
        CPU gloo, a host copy on staged gloo; with `as_bytes`, bfloat16 as
        its bytes off NCCL (gloo has no bfloat16 or int16)."""
        x = t.contiguous()
        if self.backend == "gloo-cuda":
            x = x.cpu()
        if as_bytes and self.backend != "nccl" and x.dtype == torch.bfloat16:
            x = x.view(torch.uint8)
        return x

    @staticmethod
    def _from_group(x, t):
        """The group's result `x` back in `t`'s dtype and on its device."""
        return (x if x.dtype == t.dtype else x.view(t.dtype)).to(t.device)

    def all_gather(self, t, axis: Optional[str] = None, dim: int = 0):
        """The tensors of every rank along `axis` (None: the whole mesh),
        concatenated along `dim` in axis order."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        x = self._to_group(t, as_bytes=True)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.groups[axis])
        return self._from_group(torch.cat(parts, dim=dim), t)

    def all_reduce(self, t, axis: Optional[str] = None, op: str = "sum"):
        """Sum (or with op="max" the maximum) of `t` over the ranks along
        `axis`, as a new tensor."""
        if self.axis_size(axis) == 1:
            return t
        x = self._to_group(t, as_bytes=False).clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.groups[axis])
        return self._from_group(x, t)

    def broadcast_(self, t):
        """Overwrite `t` on every rank with rank 0's, in place."""
        if self.size == 1:
            return t
        x = self._to_group(t.to(self.device) if self.backend == "nccl" else t, as_bytes=True)
        dist.broadcast(x, src=0, group=self.groups[None])
        if x is not t:
            t.copy_(self._from_group(x, t))
        return t

    def all_reduce_grad(self, t, axis: Optional[str] = None):
        """`all_reduce` that autograd differentiates: the backward sums the
        cotangents over the same ranks."""
        if self.axis_size(axis) == 1:
            return t
        return _AllReduceSum.apply(t, self, axis)

    def all_reduce_replicated(self, t, axis: Optional[str] = None):
        """`all_reduce` whose backward is the identity; see the module
        docstring."""
        if self.axis_size(axis) == 1:
            return t
        return _AllReduceReplicated.apply(t, self, axis)

    def all_gather_grad(self, t, axis: Optional[str] = None, dim: int = 0,
                        replicated: bool = False):
        """`all_gather` that autograd differentiates; see the module
        docstring. Every rank's part has the same shape."""
        if self.axis_size(axis) == 1:
            return t
        return _AllGather.apply(t, self, axis, dim, replicated)


def _rank_device(backend: str, device: Optional[torch.device] = None) -> torch.device:
    """This rank's device: `device` when given (checked against the
    backend), else cpu for "gloo" and cuda:(LOCAL_RANK mod the card count)
    for the others."""
    if device is not None:
        if (device.type == "cpu") != (backend == "gloo"):
            raise ValueError(f"a {backend!r} mesh cannot put a rank on {device}")
        if device.type == "cpu":
            return device
    elif backend == "gloo":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"a {backend!r} mesh puts its ranks on CUDA devices and "
                           "none is available; use backend='gloo' for CPU ranks")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() if dist.is_initialized() else 0))
        if backend == "nccl" and local >= torch.cuda.device_count():
            raise RuntimeError(f"NCCL puts one rank on each card: local rank {local} of "
                               f"{torch.cuda.device_count()} cards; use 'gloo-cuda'")
        device = torch.device("cuda", local % torch.cuda.device_count())
    elif device.index is None or device.index >= torch.cuda.device_count():
        raise ValueError(f"{device} is not one of the {torch.cuda.device_count()} cards")
    torch.cuda.set_device(device)
    return device


def make_mesh(n_devices: Optional[int] = None, shape=None, devices=None, *,
              backend: Optional[str] = None) -> Mesh:
    """A (data, depth, space) mesh over the `n_devices` ranks of the process
    group, with JAX's parameters in JAX's order (mvsnet_tpu/parallel/
    mesh.py:45). Every rank calls it, with the same arguments.

    n_devices: the world size (default): a mesh spans the whole group.
    shape: default `factorize_devices(n_devices)`.
    devices: the devices (torch devices or their names) in rank order, of
    which the mesh takes the first `n_devices`: rank r runs on devices[r].
    A list shorter than the world raises. Default: where `backend` puts a
    rank (the module docstring).
    backend: "nccl", "gloo" or "gloo-cuda" (see the module docstring),
    default the process group's own ("nccl" or "gloo"; a gloo group whose
    `devices` are cards gets "gloo-cuda"), or, without a process group,
    "gloo" on CPU `devices` and "nccl" (the card) otherwise. Every axis of
    size > 1 gets a subgroup: all ranks create all of them, in one order,
    as `dist.new_group` needs.
    """
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: n_devices={n}, "
                         f"world size {world}")
    shape = tuple(int(s) for s in (shape or factorize_devices(n)))
    if len(shape) != 3 or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks over {AXES}")
    rank = dist.get_rank() if grouped else 0
    device = None
    if devices is not None:
        devices = list(devices)[:n]
        if len(devices) < n:
            raise ValueError(f"{len(devices)} devices for a world of {n} ranks")
        device = torch.device(devices[rank])
    if backend is None:
        group = dist.get_backend() if grouped else None
        if device is not None and device.type == "cpu":
            backend = "gloo"
        elif device is not None and group == "gloo":
            backend = "gloo-cuda"
        else:
            backend = group or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if grouped and (dist.get_backend() == "nccl") != (backend == "nccl"):
        raise ValueError(f"mesh backend {backend!r} on a {dist.get_backend()!r} process group")
    groups = {}
    if n > 1:
        groups[None] = dist.group.WORLD
        for i, axis in enumerate(AXES):
            if shape[i] == 1:
                continue
            for ranks in axis_ranks(shape, i):
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    return Mesh(shape, rank, backend, _rank_device(backend, device), groups)
