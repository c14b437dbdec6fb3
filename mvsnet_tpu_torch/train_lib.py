"""Training library for the 3D-CNN and GRU graphs (counterpart of
mvsnet_tpu/train_lib.py): learning-rate schedule, optimizers, train state,
loss, and the train and eval steps.

PyTorch runs eagerly and updates in place: a step runs the forward in
training mode (batch-norm statistics from the batch, running statistics
updated), the backward through the port's kernels (`ops/autograd.py`,
`ops/cost_volume.py`), then the optimizer. The state is changed and also
returned, so calls read as in the JAX package. The training driver
(`train.py`) runs these steps over a data loader, with checkpoints
(`checkpoint.py`). The GRU graph trains with R-MVSNet's classification
loss and has no batch norms. With refinement the 3D-CNN loss mixes the
main depth map's loss with the refined map's (`refinement_train_mode`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mvsnet_tpu_torch import resolve_device
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from mvsnet_tpu_torch.losses import mvsnet_classification_loss, mvsnet_regression_loss
from mvsnet_tpu_torch.models.mvsnet import MVSNet, refine_outputs


def lr_schedule(tcfg: TrainConfig, step: int) -> float:
    """Continuous exponential decay base_lr * gamma^(step / stepvalue)
    (reference: train.py:256-257), read before the step's increment."""
    return tcfg.base_lr * tcfg.gamma ** (step / tcfg.stepvalue)


class RMSprop(torch.optim.Optimizer):
    """optax's `rmsprop(lr, decay, eps)`: from nu = 0,
    nu = (1 - decay) g^2 + decay nu, p += -lr (g rsqrt(nu + eps)), eps inside
    the root and no bias correction. (`torch.optim.RMSprop` puts eps outside
    the root.)"""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            decay, eps, lr = group["decay"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - decay) * p.grad.square() + decay * nu)
                p.add_(p.grad * torch.rsqrt(nu + eps) * -lr)


def make_optimizer(tcfg: TrainConfig, params) -> torch.optim.Optimizer:
    """(reference: train.py:248-271; TF1 defaults). The learning rate is
    set before every step from `lr_schedule`."""
    lr = tcfg.base_lr
    if tcfg.optimizer == "rmsprop":
        return RMSprop(params, lr, decay=0.9, eps=1e-10)
    if tcfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr, momentum=0.9, nesterov=False)
    if tcfg.optimizer == "adam":
        return torch.optim.Adam(params, lr)
    raise NotImplementedError(tcfg.optimizer)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and batch-norm statistics), the optimizer
    with its state, and the number of steps taken."""

    model: MVSNet
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: MVSNet, cfg: ModelConfig, tcfg: TrainConfig,
                       device=None) -> TrainState:
    """Moves `model` (seeded at construction, or loaded from a state dict)
    to the device, `device=None` meaning `cuda:0`, and builds the
    optimizer."""
    model = model.to(resolve_device(device)).train()
    return TrainState(model, make_optimizer(tcfg, model.parameters()))


def batch_depth_params(cams):
    """depth_start/interval/end from the reference cam's depth row
    (reference: train.py:299-305)."""
    return cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1], cams[:, 0, 1, 3, 3]


def to_device(batch, device):
    """(images, cams, depth_image, full_depth) as float32 tensors."""
    return tuple(torch.as_tensor(b, dtype=torch.float32, device=device) for b in batch)


def compute_loss(model: MVSNet, cfg: ModelConfig, tcfg: TrainConfig, batch,
                 training: bool, batch_sum=None, blocks=None):
    """Forward and loss for one batch of device tensors (reference get_loss,
    train.py:307-364; train_lib.py:71-123). Returns (loss, metrics).
    With refinement (3D-CNN only; the GRU graph ignores it, as in JAX) the
    main map's loss is against `depth_image` and the refined map's against
    `full_depth` when the net runs upsampled, else `depth_image`; they mix
    by `refinement_train_mode`: "all" (loss0 + loss1) / 2, "refine_only"
    loss1 + 1e-9 loss0, "main_only" loss0 + 1e-12 loss1 with the main
    map's <1px and <3px; "debug" is the refined map's. `batch_sum`: see
    `losses.py`; loss, metrics["loss"] and metrics["debug"] are then this
    rank's shares. `blocks` (`parallel.train_step`, multi-device) runs the
    graph on this rank's block of the volume: `blocks.forward_3dcnn` gives
    the whole depth and prob maps of the blocked 3D-CNN graph,
    `blocks.forward_prob_recurrent` the GRU graph's rows and their gather."""
    images, cams, depth_image, full_depth = batch
    depth_start, depth_interval, depth_end = batch_depth_params(cams)
    model.train(training)
    if cfg.regularization == "GRU":
        rows = gather = None
        if blocks is None:
            prob_volume = model.forward_prob_recurrent(images, cams, depth_start,
                                                       depth_interval)
        else:
            prob_volume, rows, gather = blocks.forward_prob_recurrent(
                model, images, cams, depth_start, depth_interval)
        loss, mae, l1, l3, _ = mvsnet_classification_loss(
            prob_volume, depth_image, cfg.max_d, depth_start, depth_interval, batch_sum,
            rows, gather)
        return loss, {"loss": loss.detach(), "less_one": l1, "less_three": l3,
                      "debug": mae.detach()}
    forward = model.forward_3dcnn if blocks is None else functools.partial(
        blocks.forward_3dcnn, model)
    depth_map, prob_map = forward(images, cams, depth_start, depth_interval)

    def regression_loss(estimate, target):
        return mvsnet_regression_loss(
            estimate, target, depth_start, depth_end, loss_type=tcfg.loss_type,
            alpha=tcfg.alpha, beta=tcfg.beta, eta=tcfg.eta, grad_loss=tcfg.grad_loss,
            batch_sum=batch_sum)

    loss, l1, l3, debug = regression_loss(depth_map, depth_image)
    if model.refines:
        refined, _, _ = refine_outputs(model, images, depth_map, prob_map, depth_start,
                                       depth_interval)
        loss0, l1_main, l3_main = loss, l1, l3
        loss1, l1, l3, debug = regression_loss(
            refined, full_depth if cfg.upsample_before_refinement else depth_image)
        if tcfg.refinement_train_mode == "refine_only":
            loss = loss1 + 1e-9 * loss0
        elif tcfg.refinement_train_mode == "main_only":
            loss = loss0 + 1e-12 * loss1
            l1, l3 = l1_main, l3_main
        else:
            loss = (loss0 + loss1) / 2
    metrics = {"loss": loss.detach(), "less_one": l1, "less_three": l3,
               "debug": debug.detach()}
    return loss, metrics


def apply_gradients(state: TrainState, tcfg: TrainConfig) -> TrainState:
    """One optimizer update at the schedule's rate for `state.step`."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr_schedule(tcfg, state.step)
    state.optimizer.step()
    state.step += 1
    return state


def make_train_step(model: MVSNet, cfg: ModelConfig, tcfg: TrainConfig):
    """train_step(state, batch) -> (state, metrics): forward in training
    mode, backward, one optimizer update. `batch` is (images, cams,
    depth_image, full_depth) as arrays or tensors."""

    def train_step(state: TrainState, batch):
        batch = to_device(batch, state.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = compute_loss(model, cfg, tcfg, batch, training=True)
        loss.backward()
        return apply_gradients(state, tcfg), metrics

    return train_step


def make_eval_step(model: MVSNet, cfg: ModelConfig, tcfg: TrainConfig):
    """eval_step(state, batch) -> metrics, with running statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        batch = to_device(batch, state.device)
        _, metrics = compute_loss(model, cfg, tcfg, batch, training=False)
        return metrics

    return eval_step
