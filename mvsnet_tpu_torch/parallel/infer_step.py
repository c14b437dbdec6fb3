"""Sharded inference over a mesh (counterpart of
mvsnet_tpu/parallel/infer_step.py:25-153).

Two regimes, chosen per call by the batch size B over the mesh's n ranks:

* **Throughput** (B % n == 0): each rank runs the single-device forward
  on its B / n maps, in rank order (JAX's batch spec over all three axes),
  and the outputs are all-gathered, so every rank holds the whole
  (B, h, w, 1) result, as JAX's replicated output.
* **Latency** (otherwise, typically B = 1): one map's volume is split
  over 'depth' x 'space' (`forward_3dcnn_blocks`, which the train step
  shares). Every rank runs the 2D feature tower on its 'space' row block
  of every level, with halos (`UNetDS2GN.forward_blocks`: JAX constrains
  the tower's output over 'space' and GSPMD splits each layer's rows; the
  'depth' ranks of a row block compute the same rows); the row- and
  depth-sliced cost kernel K1s computes its depth x space
  block of the cost volume (`sweep_cost_volume_sharded`); the 3D U-Net
  runs on the blocks with halo exchanges over 'depth' and 'space'
  (`RegNetUS0.forward_sharded`); the collective soft-argmin tail
  (`ops.depth.soft_argmin_prob_map_sharded`) leaves each rank its rows of
  the depth and prob maps, which are all-gathered over 'space', so every
  rank holds the whole maps. With refinement every rank then runs the
  refinement network whole on them. The 'data' axis replicates this
  regime. No rank holds a whole (D, h, w) volume; where an axis cannot be
  split (`models.regnet.plan_volume`) the U-Net runs whole along it, with
  a warning.

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
from mvsnet_tpu_torch.models.regnet import VolumePlan, plan_volume
from mvsnet_tpu_torch.ops.cost_volume import sweep_cost_volume_sharded
from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map_sharded
from mvsnet_tpu_torch.parallel.mesh import Mesh

LATENCY_STAGES = ("features", "cost_volume", "regnet", "collective_tail")


def _pad_batch(xs, B: int, n: int):
    """Every tensor's leading batch axis padded from B up to the next
    multiple of n by repeating the last map (infer_step.py:25-31)."""
    pad = (-B) % n
    return tuple(torch.cat([x] + [x[-1:]] * pad, dim=0) for x in xs)


def forward_3dcnn_blocks(model: MVSNet, mesh: Mesh, images, cams, depth_start,
                         depth_interval, on_stage: Optional[Callable[[str], None]] = None,
                         plan: Optional[VolumePlan] = None):
    """`model.forward_3dcnn` with the volume in depth x space blocks over
    the mesh (see the module docstring), in eval or, with the model in
    training mode, differentiable: the views' gather over 'space' and the
    halos send their gradients back, the tail's sums over 'depth' pass the
    whole cotangent to every slab (the ranks use the maps alike), and the
    maps' gather over 'space' hands each rank its rows' cotangent. Returns
    depth_map, prob_map, each (B, h, w, 1) float32, whole on every rank.
    `on_stage(name)` is called after each of `LATENCY_STAGES`; `plan`
    (default `plan_volume` of the features) lays out the volume, and the
    tower runs on its rows (`MVSNet.extract_features`' blocks)."""
    mark = on_stage or (lambda name: None)
    B, _, H, W = images.shape[:4]
    ds, di, de = model.depth_range(depth_start, depth_interval, B, images.device)
    h, w = -(-H // 4), -(-W // 4)
    model.check_feature_shape(h, w)
    plan = plan or plan_volume(mesh, model.cfg.max_d, h)
    if (plan.depth.size, plan.rows.size) != (model.cfg.max_d, h):
        raise ValueError(f"a plan of {plan.depth.size} planes and {plan.rows.size} rows for "
                         f"{model.cfg.max_d} planes and {h} feature rows")
    ref_f, view_f = model.extract_features(images, (mesh, plan.rows))
    mark("features")
    cost = sweep_cost_volume_sharded(ref_f, view_f, model.homographies(cams, ds, di, de), mesh,
                                     depth=plan.depth, rows=plan.rows)
    mark("cost_volume")
    reg = model.regnet.forward_sharded(cost, mesh, plan)[..., 0].to(torch.float32)
    mark("regnet")
    cfg, by_depth = model.cfg, plan.depth.n > 1
    depth, prob = soft_argmin_prob_map_sharded(
        reg, plan.depth.bounds()[0], ds, di, cfg.max_d, inverse_depth=cfg.inverse_depth,
        depth_end=de, num_buckets=cfg.prob_num_buckets,
        reduce_sum=(lambda t: mesh.all_reduce_replicated(t, "depth")) if by_depth else None,
        reduce_max=(lambda t: mesh.all_reduce(t, "depth", op="max")) if by_depth else None)
    if plan.rows.n > 1:
        depth, prob = (mesh.all_gather_grad(t, "space", dim=1, replicated=True)
                       for t in (depth, prob))
    mark("collective_tail")
    return depth, prob


def latency_forward(model: MVSNet, mesh: Mesh, images, cams, depth_start, depth_interval,
                    on_stage: Optional[Callable[[str], None]] = None):
    """The latency regime on this rank; see the module docstring. Returns
    (depth_map, prob_map, residual) as `apply_forward_3dcnn` does.
    `on_stage(name)`, where given, is called after each of
    `LATENCY_STAGES`, and with refinement after "refine"."""
    depth, prob = forward_3dcnn_blocks(model, mesh, images, cams, depth_start, depth_interval,
                                       on_stage)
    if not model.refines:
        return depth, prob, torch.zeros_like(depth)
    B = images.shape[0]
    ds, di, _ = model.depth_range(depth_start, depth_interval, B, images.device)
    out = refine_outputs(model, images, depth, prob, ds, di)
    if on_stage is not None:
        on_stage("refine")
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
