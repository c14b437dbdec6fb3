"""Regression losses and accuracy metrics (counterpart of
mvsnet_tpu/losses.py:29-158).

  * original_loss: masked MAE in depth-interval units;
  * power_loss: N*(|dy| + 0.005 y)^alpha / y^beta with the 10 * mean^beta /
    interval^alpha normalisation;
  * gaussian_loss: -exp(-dy^2 / 2 (eta y)^2);
  * gradient_loss: log-gradient difference over the spatial axes (the JAX
    package's intended form, not the reference's batch-axis slice);
  * <1 and <3 interval metrics;
  * mvsnet_regression_loss with the fixed (end - start) / 191 interval.

Pixels with y_true == 0 are invalid everywhere. Tensors are (B, H, W, 1);
sums are float32. The GRU classification loss waits for the GRU slice.
"""

from __future__ import annotations

import torch


def _mask_and_count(y_true):
    mask = (y_true != 0.0).to(torch.float32)
    count = torch.abs(mask.sum(dim=(1, 2, 3))) + 1e-6
    return mask, count


def original_loss(y_true, y_pred, interval):
    """Masked MAE in interval units, averaged over valid pixels, summed
    over the batch (reference: loss.py:15-28)."""
    interval = interval.reshape(y_pred.shape[0])
    mask, count = _mask_and_count(y_true)
    mae = torch.abs(mask * (y_true - y_pred)).sum(dim=(1, 2, 3))
    return torch.sum((mae / interval) / count)


def power_loss(y_true, y_pred, interval, alpha: float, beta: float):
    """(reference: loss.py:31-90)"""
    interval = interval.reshape(y_pred.shape[0])
    mask, count = _mask_and_count(y_true)
    if beta == 0.0:
        denominator = count[:, None, None, None]
    else:
        denominator = torch.pow(y_true + 1e-9, beta) * count[:, None, None, None]
    numerator = torch.abs(y_true - y_pred) + 0.005 * y_true
    if alpha != 1.0:
        numerator = torch.pow(numerator, alpha)
    numerator = numerator * mask
    loss = torch.sum(numerator / denominator, dim=(1, 2, 3))
    mean_true_depth = torch.sum(y_true * mask) / count
    normalization = 10.0 * torch.pow(mean_true_depth, beta) / torch.pow(interval, alpha)
    return torch.sum(loss * normalization)


def gaussian_loss(y_true, y_pred, interval, eta: float):
    """(reference: loss.py:93-131)"""
    mask, count = _mask_and_count(y_true)
    sigma = eta * y_true + 1e-6
    error = (y_true - y_pred) * mask
    loss = -torch.exp(-torch.pow(error / sigma, 2.0) / 2.0)
    return torch.sum(torch.sum(loss) / count)


def gradient_loss(y_true, y_pred):
    """Log-gradient difference over the spatial axes of (B, H, W, 1) maps."""
    mask = (y_true != 0.0).to(torch.float32)
    num_valid = mask.sum()
    diff = y_true - y_pred
    v_grad = torch.abs((diff[:, :-2, :] - diff[:, 2:, :]) * (mask[:, :-2, :] * mask[:, 2:, :]))
    h_grad = torch.abs((diff[:, :, :-2] - diff[:, :, 2:]) * (mask[:, :, :-2] * mask[:, :, 2:]))
    return (torch.log(1.0 + v_grad).sum() + torch.log(1.0 + h_grad).sum()) / num_valid


def _less_x_percentage(y_true, y_pred, interval, x: float):
    interval = interval.reshape(y_pred.shape[0])[:, None, None, None]
    mask = (y_true != 0.0).to(torch.float32)
    denom = torch.abs(mask.sum()) + 1e-6
    abs_diff = torch.abs(y_true - y_pred) / interval
    return torch.sum(mask * (abs_diff <= x).to(torch.float32)) / denom


def less_one_percentage(y_true, y_pred, interval):
    """Fraction of valid pixels with |err| <= 1 interval (loss.py:162-173)."""
    return _less_x_percentage(y_true, y_pred, interval, 1.0)


def less_three_percentage(y_true, y_pred, interval):
    """(reference: loss.py:176-187)"""
    return _less_x_percentage(y_true, y_pred, interval, 3.0)


def mvsnet_regression_loss(estimated_depth, depth_image, depth_start, depth_end,
                           loss_type: str = "original", alpha: float = 1.0,
                           beta: float = 0.0, eta: float = 0.02,
                           grad_loss: bool = True):
    """Loss, <1 and <3 interval metrics with the fixed (end - start) / 191
    interval (reference: loss.py:190-220). Returns (loss, less_one,
    less_three, debug), debug the gradient-loss term or 0."""
    depth_interval = (depth_end - depth_start) / 191.0
    if loss_type == "original":
        loss = original_loss(depth_image, estimated_depth, depth_interval)
    elif loss_type == "power":
        loss = power_loss(depth_image, estimated_depth, depth_interval, alpha, beta)
    elif loss_type == "gaussian":
        loss = gaussian_loss(depth_image, estimated_depth, depth_interval, eta)
    else:
        raise NotImplementedError(loss_type)
    debug = torch.zeros((), dtype=torch.float32, device=estimated_depth.device)
    if grad_loss:
        debug = gradient_loss(depth_image, estimated_depth)
        loss = loss + 0.5 * debug
    with torch.no_grad():
        less_one = less_one_percentage(depth_image, estimated_depth, depth_interval)
        less_three = less_three_percentage(depth_image, estimated_depth, depth_interval)
    return loss, less_one, less_three, debug
