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

The collectives the port uses are `all_gather` and `all_reduce` (sum)
along one axis or the whole mesh, `all_reduce_grad`, whose backward
is the same sum, and `broadcast_` from rank 0 (`shard_state`). The boundary-plane exchange of the depth-sharded U-Net
is an `all_gather` over 'depth' (`parallel/halo.py`).
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


def shards(dim_size: int, axis_size: int) -> bool:
    """The rule of `constrain` (mesh.py:88-112): an axis shards a dimension
    only where the dimension divides evenly over it; otherwise that
    dimension stays whole (replicated)."""
    return axis_size > 1 and dim_size % axis_size == 0


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

    def all_reduce(self, t, axis: Optional[str] = None):
        """Sum of `t` over the ranks along `axis`, as a new tensor."""
        if self.axis_size(axis) == 1:
            return t
        x = self._to_group(t, as_bytes=False).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.groups[axis])
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


def _rank_device(backend: str) -> torch.device:
    if backend == "gloo":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"a {backend!r} mesh puts its ranks on CUDA devices and "
                           "none is available; use backend='gloo' for CPU ranks")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    device = torch.device("cuda", local % torch.cuda.device_count())
    if backend == "nccl" and local >= torch.cuda.device_count():
        raise RuntimeError(f"NCCL puts one rank on each card: local rank {local} of "
                           f"{torch.cuda.device_count()} cards; use 'gloo-cuda'")
    torch.cuda.set_device(device)
    return device


def make_mesh(n: Optional[int] = None, shape=None, backend: Optional[str] = None) -> Mesh:
    """A (data, depth, space) mesh over the `n` ranks of the process group
    (every rank calls it, with the same arguments).

    n: the world size (default); shape: default `factorize_devices(n)`;
    backend: "nccl", "gloo" or "gloo-cuda" (see the module docstring),
    default the process group's own ("nccl" or "gloo"), or "nccl" (the
    card) without a process group. Every axis of size > 1 gets a subgroup:
    all ranks create all of them, in one order, as `dist.new_group` needs.
    """
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: n={n}, world size {world}")
    shape = tuple(int(s) for s in (shape or factorize_devices(n)))
    if len(shape) != 3 or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks over {AXES}")
    if backend is None:
        backend = dist.get_backend() if grouped else "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if grouped and (dist.get_backend() == "nccl") != (backend == "nccl"):
        raise ValueError(f"mesh backend {backend!r} on a {dist.get_backend()!r} process group")
    rank = dist.get_rank() if grouped else 0
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
    return Mesh(shape, rank, backend, _rank_device(backend), groups)
