"""The sharded train and eval steps (counterpart of
mvsnet_tpu/parallel/train_step.py:24-77, and of the single-device steps
they equal, tests/test_parallel.py:45-75), and `shard_state`.

Parameters and optimizer state are replicated; each rank of the 'data'
axis takes its slice of the batch. Along 'depth' and 'space' the ranks of
a data group split the volume, as JAX's constraints do inside the jitted
step (models/mvsnet.py:174, :179, :228):
  * the 3D-CNN graph runs on the rank's depth x space block
    (`infer_step.forward_3dcnn_blocks`: the feature tower on the rank's
    rows of every level, with halos and its group norms' moments gathered
    over 'space'; the cost volume's block by K1s, K2 and K3 with a row
    offset backward; the U-Net with halo exchanges that send their
    gradients back; the collective soft-argmin tail);
  * the GRU graph runs the tower on the rank's rows as the 3D-CNN does,
    and its sweep on the rank's rows over all D planes
    (`MVSNet.gru_cost_sweep`'s `blocks`), the cells with one-row halos
    and their norms' statistics summed over 'space'.
What GSPMD gives the JAX step for free is written out, because a plain
data-parallel average would differ:
  * the losses are sums over the batch, not means, so the gradients are
    *summed* over 'data', not averaged; every batch-wide sum or count of
    the losses (`losses.py`) is summed over 'data' before it is used, each
    rank's loss being its share;
  * the maps after the tail (and the GRU's per-pixel loss terms) are
    gathered over 'space', so every rank of a data group takes its maps'
    loss whole, once along 'depth' and 'space';
  * a parameter's gradient is summed over the axes along which its copies
    saw different parts of the loss: the feature tower, the U-Net and the
    GRU over 'data' and the axes that split the volume, once each (the
    tower's copy on a rank holds its rows' share over 'space', and of
    those rows the share its depth slab's cotangent gives over 'depth':
    the halos' and norm gathers' backwards return the cotangents within a
    'space' group, so no share is counted twice; where the tower runs
    whole it receives only its block's cotangent, the same shares); the
    refinement net, which runs on the gathered maps alike along 'depth'
    and 'space', over 'data' only;
  * training batch norms sum their per-channel sums and sums of squares
    (differentiably) over 'data' and the axes whose blocks the U-Net
    holds apart, so their statistics are the global batch's and the
    running statistics agree on every rank.
The metrics are global.
"""

from __future__ import annotations

import contextlib
import functools
import logging

import torch

from mvsnet_tpu_torch import train_lib
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from mvsnet_tpu_torch.models.layers import BatchNormRef
from mvsnet_tpu_torch.models.mvsnet import MVSNet
from mvsnet_tpu_torch.models.regnet import plan_volume
from mvsnet_tpu_torch.parallel.infer_step import forward_3dcnn_blocks
from mvsnet_tpu_torch.parallel.mesh import AxisSplit, Mesh

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def global_batch_norms(model, sync):
    """For the length of the block, the model's training batch norms sum
    their statistics through `sync` (None: the local batch's); the model
    holds no mesh state after it."""
    norms = [m for m in model.modules() if isinstance(m, BatchNormRef)]
    for m in norms:
        m.batch_sum = sync
    try:
        yield
    finally:
        for m in norms:
            m.batch_sum = None


def _sum_over(mesh: Mesh, t, axes, grad: bool = False):
    """t summed over the ranks of every axis in `axes` (one after the
    other: the sum over their product), differentiably with `grad`."""
    for axis in axes:
        t = mesh.all_reduce_grad(t, axis) if grad else mesh.all_reduce(t, axis)
    return t


class _Blocks:
    """The graph's forward on this rank's block (`train_lib.compute_loss`'s
    `blocks`), and the axes each sum of the step runs over: `split`, those
    along which the ranks hold different blocks, `norms` those of them
    whose blocks the U-Net's batch norms see apart."""

    def __init__(self, mesh: Mesh, cfg: ModelConfig, feature_height: int):
        self.mesh = mesh
        if cfg.regularization == "GRU":
            sp = mesh.axis_size("space")
            if feature_height % sp:
                logger.warning("GRU: %d feature rows do not divide over %d 'space' ranks; "
                               "every rank sweeps them all", feature_height, sp)
                sp = 1
            self.rows = AxisSplit("space", feature_height, sp, mesh.axis_index("space") % sp)
            self.plan = None
            self.split = ("space",) if sp > 1 else ()
            self.norms = ()
        else:
            self.plan = plan_volume(mesh, cfg.max_d, feature_height)
            self.split = self.plan.sharded
            self.norms = tuple(a for a in self.split if a not in self.plan.gathered)

    @classmethod
    def of(cls, mesh: Mesh, cfg: ModelConfig, feature_height: int):
        """The blocks of this step, or None where no axis splits the volume."""
        blocks = cls(mesh, cfg, feature_height)
        return blocks if blocks.split else None

    def forward_3dcnn(self, model, images, cams, depth_start, depth_interval):
        return forward_3dcnn_blocks(model, self.mesh, images, cams, depth_start,
                                    depth_interval, plan=self.plan)

    def forward_prob_recurrent(self, model, images, cams, depth_start, depth_interval):
        prob = model.forward_prob_recurrent(images, cams, depth_start, depth_interval,
                                            blocks=(self.mesh, self.rows))
        return prob, self.rows.bounds(), self.gather

    def gather(self, t):
        """A (B, hl, w, 1) map of this rank's rows -> the whole map, whose
        every rank takes the loss alike."""
        return self.mesh.all_gather_grad(t, "space", dim=1, replicated=True)


def make_sharded_train_step(model: MVSNet, cfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh):
    """train_step(state, batch) -> (state, metrics). Every rank calls it
    with the whole batch (images, cams, depth_image, full_depth) as
    arrays; B must divide over 'data'. `state` comes from
    `train_lib.create_train_state(model, ..., device=mesh.device)` on every
    rank from the same weights. The volume splits over 'depth' and 'space'
    as the module docstring says (the GRU over 'space' only: its depth is
    the scan); the model's batch norms sum their statistics over the mesh
    only inside a step."""
    n, i = mesh.axis_size("data"), mesh.axis_index("data")
    batch_sum = None if n == 1 else (lambda t: mesh.all_reduce(t, "data"))
    alike = [p for name, p in model.named_parameters() if name.startswith("refine_net.")]
    # one plan (and its warnings) per feature height
    blocks_for = functools.lru_cache(maxsize=None)(lambda h: _Blocks.of(mesh, cfg, h))

    def train_step(state, batch):
        B = batch[0].shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} does not split over {n} 'data' ranks")
        mine = slice(i * (B // n), (i + 1) * (B // n))
        local = train_lib.to_device(tuple(b[mine] for b in batch), state.device)
        blocks = blocks_for(local[0].shape[2] // 4)
        split = ("data",) + (blocks.split if blocks else ())
        norms = ("data",) + (blocks.norms if blocks else ())
        norms = tuple(a for a in norms if mesh.axis_size(a) > 1)
        sync = (lambda t: _sum_over(mesh, t, norms, grad=True)) if norms else None
        state.optimizer.zero_grad(set_to_none=True)
        with global_batch_norms(model, sync):
            loss, metrics = train_lib.compute_loss(model, cfg, tcfg, local, training=True,
                                                   batch_sum=batch_sum, blocks=blocks)
            loss.backward()
        for params, axes in ((alike, ("data",)),
                             ([p for p in model.parameters()
                               if not any(p is q for q in alike)], split)):
            axes = tuple(a for a in axes if mesh.axis_size(a) > 1)
            grads = [p.grad for p in params if p.grad is not None]
            if not axes or not grads:
                continue
            total = _sum_over(mesh, torch.cat([g.reshape(-1) for g in grads]), axes)
            offset = 0
            for g in grads:
                g.copy_(total[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        if batch_sum is not None:
            metrics["loss"] = batch_sum(metrics["loss"])
            metrics["debug"] = batch_sum(metrics["debug"])
        return train_lib.apply_gradients(state, tcfg), metrics

    return train_step


def shard_state(state, mesh: Mesh):
    """Replicate a TrainState over the mesh (JAX's `shard_state`, :58):
    rank 0's parameters, buffers and optimizer state are broadcast to every
    rank, in place, so that ranks that built their states apart hold equal
    ones. Returns `state`."""
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    for slot in state.optimizer.state.values():
        tensors += [v for _, v in sorted(slot.items()) if torch.is_tensor(v)]
    step = torch.tensor([state.step], dtype=torch.int64)
    with torch.no_grad():
        for t in tensors + [step]:
            mesh.broadcast_(t)
    state.step = int(step.item())
    return state


def make_sharded_eval_step(model: MVSNet, cfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh):
    """eval_step(state, batch) -> metrics (JAX's `make_sharded_eval_step`,
    :64): the eval forward on each 'data' rank's slice of the whole batch,
    with running statistics, and the metrics summed over 'data' through the
    same `batch_sum` as `make_sharded_train_step`, so every rank returns
    the global batch's metrics."""
    n, i = mesh.axis_size("data"), mesh.axis_index("data")
    batch_sum = None if n == 1 else (lambda t: mesh.all_reduce(t, "data"))

    @torch.no_grad()
    def eval_step(state, batch):
        B = batch[0].shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} does not split over {n} 'data' ranks")
        mine = slice(i * (B // n), (i + 1) * (B // n))
        local = train_lib.to_device(tuple(b[mine] for b in batch), state.device)
        _, metrics = train_lib.compute_loss(model, cfg, tcfg, local, training=False,
                                            batch_sum=batch_sum)
        if batch_sum is not None:
            metrics["loss"] = batch_sum(metrics["loss"])
            metrics["debug"] = batch_sum(metrics["debug"])
        return metrics

    return eval_step
