"""The sharded train and eval steps (counterpart of
mvsnet_tpu/parallel/train_step.py:24-77, and of the single-device steps
they equal, tests/test_parallel.py:45-75), and `shard_state`.

Parameters and optimizer state are replicated; each rank of the 'data'
axis takes its slice of the batch. What GSPMD gives the JAX step for free
is written out, because a plain data-parallel average would differ:
  * the losses are sums over the batch, not means, so the gradients are
    *summed* over 'data', not averaged;
  * every batch-wide sum or count of the losses (`losses.py`) is summed
    over 'data' before it is used, each rank's loss being its share;
  * training batch norms sum their per-channel sums and sums of squares
    over 'data' (differentiably), so their statistics are the global
    batch's and the running statistics agree on every rank.
The metrics are global. Ranks along 'depth' and 'space' repeat their data
group's step: sharding the training volume is later work.
"""

from __future__ import annotations

import contextlib

import torch

from mvsnet_tpu_torch import train_lib
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from mvsnet_tpu_torch.models.layers import BatchNormRef
from mvsnet_tpu_torch.models.mvsnet import MVSNet
from mvsnet_tpu_torch.parallel.mesh import Mesh


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


def make_sharded_train_step(model: MVSNet, cfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh):
    """train_step(state, batch) -> (state, metrics). Every rank calls it
    with the whole batch (images, cams, depth_image, full_depth) as
    arrays; B must divide over 'data'. `state` comes from
    `train_lib.create_train_state(model, ..., device=mesh.device)` on every
    rank from the same weights. The model's batch norms sum their
    statistics over 'data' only inside a step."""
    n, i = mesh.axis_size("data"), mesh.axis_index("data")
    sync = None
    batch_sum = None
    if n > 1:
        def sync(t):
            return mesh.all_reduce_grad(t, "data")

        def batch_sum(t):
            return mesh.all_reduce(t, "data")

    def train_step(state, batch):
        B = batch[0].shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} does not split over {n} 'data' ranks")
        mine = slice(i * (B // n), (i + 1) * (B // n))
        local = train_lib.to_device(tuple(b[mine] for b in batch), state.device)
        state.optimizer.zero_grad(set_to_none=True)
        with global_batch_norms(model, sync):
            loss, metrics = train_lib.compute_loss(model, cfg, tcfg, local, training=True,
                                                   batch_sum=batch_sum)
            loss.backward()
        if n > 1:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            total = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), "data")
            offset = 0
            for g in grads:
                g.copy_(total[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
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
