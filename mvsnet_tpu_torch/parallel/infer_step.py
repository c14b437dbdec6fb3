"""Sharded inference over a mesh (counterpart of
mvsnet_tpu/parallel/infer_step.py:25-153).

Two regimes, chosen per call by the batch size B over the mesh's n ranks:

* **Throughput** (B % n == 0): each rank runs the single-device forward
  on its B / n maps, in rank order (JAX's batch spec over all three axes),
  and the outputs are all-gathered, so every rank holds the whole
  (B, h, w, 1) result, as JAX's replicated output.
* **Latency** (otherwise, typically B = 1): one map's volume is split.
  Every rank runs the 2D feature tower and keeps its 'space' row shard of
  the features; the row- and depth-sliced cost kernel K1s computes its
  block of the cost volume (`sweep_cost_volume_sharded`); the blocks are
  all-gathered over 'space' into the rank's depth slab; the 3D U-Net runs
  on the slabs with halo exchanges over 'depth'
  (`RegNetUS0.forward_sharded`); the 1-channel regularized slabs (B, Dl,
  h, w) float32 are all-gathered over 'depth', and the soft-argmin tail
  runs whole on every rank. With refinement every rank then holds the
  whole depth and prob maps and runs the refinement network whole on
  them. The 'data' axis replicates this regime. The U-Net does not shard
  rows yet: the cost volume's row blocks are gathered before it.

Refinement runs in both regimes, as in JAX (infer_step.py:53-79): in the
throughput regime inside the single-device forward on each rank's maps.

The GRU (`make_sharded_gru_forward`) has the throughput regime only: its
depth sweep is sequential, so a batch that does not divide over the ranks
is padded by repeating its last map, and the padding is sliced off.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn, refine_outputs
from mvsnet_tpu_torch.ops.cost_volume import sweep_cost_volume_sharded
from mvsnet_tpu_torch.parallel.mesh import Mesh

LATENCY_STAGES = ("features", "cost_volume", "space_gather", "regnet", "depth_gather_tail")


def _pad_batch(xs, B: int, n: int):
    """Every tensor's leading batch axis padded from B up to the next
    multiple of n by repeating the last map (infer_step.py:25-31)."""
    pad = (-B) % n
    return tuple(torch.cat([x] + [x[-1:]] * pad, dim=0) for x in xs)


def latency_forward(model: MVSNet, mesh: Mesh, images, cams, depth_start, depth_interval,
                    on_stage: Optional[Callable[[str], None]] = None):
    """The latency regime on this rank; see the module docstring. Returns
    (depth_map, prob_map, residual) as `apply_forward_3dcnn` does.
    `on_stage(name)`, where given, is called after each of
    `LATENCY_STAGES`, and with refinement after "refine"."""
    mark = on_stage or (lambda name: None)
    B = images.shape[0]
    ds, di, de = model.depth_range(depth_start, depth_interval, B, images.device)
    ref_f, view_f = model.extract_features(images)
    h, w = ref_f.shape[1:3]
    model.check_feature_shape(h, w)
    sp, s = mesh.axis_size("space"), mesh.axis_index("space")
    if h % sp:
        raise ValueError(f"feature height {h} does not split over {sp} 'space' ranks")
    rows = slice(s * (h // sp), (s + 1) * (h // sp))
    ref_l, views_l = ref_f[:, rows], view_f[:, :, rows]
    mark("features")
    cost = sweep_cost_volume_sharded(ref_l, views_l, model.homographies(cams, ds, di, de), mesh)
    mark("cost_volume")
    cost = mesh.all_gather(cost, "space", dim=2)                    # (B, Dl, h, w, C)
    mark("space_gather")
    reg = model.regnet.forward_sharded(cost, mesh)[..., 0].to(torch.float32)
    mark("regnet")
    reg = mesh.all_gather(reg.contiguous(), "depth", dim=1)          # (B, D, h, w)
    depth, prob = model.depth_tail(reg, ds, di, de)
    mark("depth_gather_tail")
    if not model.refines:
        return depth, prob, torch.zeros_like(depth)
    out = refine_outputs(model, images, depth, prob, ds, di)
    mark("refine")
    return out


def throughput_forward(model: MVSNet, mesh: Mesh, images, cams, depth_start, depth_interval):
    """The throughput regime on this rank (B % n == 0); see the module
    docstring."""
    B = images.shape[0]
    ds, di, _ = model.depth_range(depth_start, depth_interval, B, images.device)
    Bl = B // mesh.size
    mine = slice(mesh.rank * Bl, (mesh.rank + 1) * Bl)
    out = apply_forward_3dcnn(model, images[mine], cams[mine], ds[mine], di[mine])
    return tuple(mesh.all_gather(o.contiguous(), None, dim=0) for o in out)


def make_sharded_forward(model: MVSNet, mesh: Mesh):
    """forward(images, cams, depth_start, depth_interval) -> (depth_map,
    prob_map, residual) over `mesh`, every rank calling it with the same
    inputs (tensors on the rank's device; depth_start, depth_interval
    (B,)). The eval model is replicated on every rank."""

    def forward(images, cams, depth_start, depth_interval):
        B = images.shape[0]
        if mesh.size > 1 and B % mesh.size == 0:
            return throughput_forward(model, mesh, images, cams, depth_start, depth_interval)
        if mesh.size > 1:
            return latency_forward(model, mesh, images, cams, depth_start, depth_interval)
        return apply_forward_3dcnn(model, images, cams, depth_start, depth_interval)

    return forward


def make_sharded_gru_forward(model: MVSNet, mesh: Mesh):
    """forward(images, cams, depth_start, depth_end) -> (depth_map,
    prob_map), `forward_gru_wta` over `mesh` (infer_step.py:102-153): the
    batch is padded to a multiple of the ranks (`_pad_batch`), each rank
    runs its maps in rank order, the results are all-gathered and sliced
    back to B. Every rank calls it with the same inputs; the eval model is
    replicated."""

    def forward(images, cams, depth_start, depth_end):
        B = images.shape[0]
        if mesh.size == 1:
            return model.forward_gru_wta(images, cams, depth_start, None, depth_end)
        xs = _pad_batch((images, cams, depth_start.expand(B), depth_end.expand(B)), B,
                        mesh.size)
        Bl = xs[0].shape[0] // mesh.size
        mine = slice(mesh.rank * Bl, (mesh.rank + 1) * Bl)
        images, cams, ds, de = (x[mine] for x in xs)
        out = model.forward_gru_wta(images, cams, ds, None, de)
        return tuple(mesh.all_gather(o.contiguous(), None, dim=0)[:B] for o in out)

    return forward
