"""Regression and classification losses and accuracy metrics (counterpart
of mvsnet_tpu/losses.py:29-195).

  * non_zero_mean_absolute_diff / original_loss: masked MAE in
    depth-interval units;
  * power_loss: N*(|dy| + 0.005 y)^alpha / y^beta with the 10 * mean^beta /
    interval^alpha normalisation (mean^beta alone with no_interval_norm);
  * gaussian_loss: -exp(-dy^2 / 2 (eta y)^2);
  * gradient_loss: log-gradient difference over the spatial axes (the JAX
    package's intended form, not the reference's batch-axis slice), or
    without the log;
  * <1 and <3 interval metrics;
  * mvsnet_regression_loss with the fixed (end - start) / 191 interval;
  * mvsnet_classification_loss: R-MVSNet's cross entropy at the
    ground-truth plane and the winner-take-all metrics.

Pixels with y_true == 0 are invalid everywhere. Depth tensors are (B, H, W,
1); sums are float32.

With the batch sharded over ranks (`parallel/train_step.py`), `batch_sum`
sums a tensor over the ranks that hold the rest of the batch. Every term
that JAX takes over the whole batch (power_loss's depth sum, losses.py:68;
gaussian_loss's sum, :83; gradient_loss's count, :93; the metrics' counts,
:123) goes through it, and each rank's loss is its share: the ranks'
losses add up to the global loss, and so do their gradients.

With a map's rows split over 'space' as well (R-MVSNet's training sweep),
the classification loss takes this rank's rows of the probability volume
and a `gather` of its per-pixel terms over the row blocks: every rank of a
data group then holds its maps' whole terms and takes the loss whole, once
along 'space' (the gather's backward hands each rank its rows' cotangent).
"""

from __future__ import annotations

import torch


def _mask_and_count(y_true):
    mask = (y_true != 0.0).to(torch.float32)
    count = torch.abs(mask.sum(dim=(1, 2, 3))) + 1e-6
    return mask, count


def non_zero_mean_absolute_diff(y_true, y_pred, interval):
    """Masked MAE in interval units, averaged over each map's valid pixels,
    summed over the batch (losses.py:35-42; reference: loss.py:15-28).
    Every term is per map, so with the batch sharded a rank's value is its
    share of the global one."""
    interval = interval.reshape(y_pred.shape[0])
    mask, count = _mask_and_count(y_true)
    mae = torch.abs(mask * (y_true - y_pred)).sum(dim=(1, 2, 3))
    return torch.sum((mae / interval) / count)


def original_loss(y_true, y_pred, interval):
    """(reference: loss.py:15-28)"""
    return non_zero_mean_absolute_diff(y_true, y_pred, interval)


def _total(batch_sum, t):
    return t if batch_sum is None else batch_sum(t)


def power_loss(y_true, y_pred, interval, alpha: float, beta: float,
               no_interval_norm: bool = False, batch_sum=None):
    """(reference: loss.py:31-90); `no_interval_norm` drops the
    10 / interval^alpha factor of the normalisation."""
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
    mean_true_depth = _total(batch_sum, torch.sum(y_true * mask)) / count
    if no_interval_norm:
        normalization = torch.pow(mean_true_depth, beta)
    else:
        normalization = 10.0 * torch.pow(mean_true_depth, beta) / torch.pow(interval, alpha)
    return torch.sum(loss * normalization)


def gaussian_loss(y_true, y_pred, interval, eta: float, batch_sum=None):
    """(reference: loss.py:93-131): sum(loss) / count summed over the
    batch, sum(loss) over the whole batch."""
    mask, count = _mask_and_count(y_true)
    sigma = eta * y_true + 1e-6
    error = (y_true - y_pred) * mask
    loss = -torch.exp(-torch.pow(error / sigma, 2.0) / 2.0)
    # sum_b (sum(loss) / count_b); with batch_sum this rank's share of it
    return torch.sum(loss) * _total(batch_sum, torch.sum(1.0 / count))


def gradient_loss(y_true, y_pred, log: bool = True, batch_sum=None):
    """Log-gradient difference over the spatial axes of (B, H, W, 1) maps,
    over the valid pixels of the whole batch; `log=False` sums the absolute
    gradient differences themselves."""
    mask = (y_true != 0.0).to(torch.float32)
    num_valid = _total(batch_sum, mask.sum())
    diff = y_true - y_pred
    v_grad = torch.abs((diff[:, :-2, :] - diff[:, 2:, :]) * (mask[:, :-2, :] * mask[:, 2:, :]))
    h_grad = torch.abs((diff[:, :, :-2] - diff[:, :, 2:]) * (mask[:, :, :-2] * mask[:, :, 2:]))
    if log:
        v_grad, h_grad = torch.log(1.0 + v_grad), torch.log(1.0 + h_grad)
    return (v_grad.sum() + h_grad.sum()) / num_valid


def _less_x_percentage(y_true, y_pred, interval, x: float, batch_sum=None):
    interval = interval.reshape(y_pred.shape[0])[:, None, None, None]
    mask = (y_true != 0.0).to(torch.float32)
    denom = torch.abs(_total(batch_sum, mask.sum())) + 1e-6
    abs_diff = torch.abs(y_true - y_pred) / interval
    good = torch.sum(mask * (abs_diff <= x).to(torch.float32))
    return _total(batch_sum, good) / denom


def less_one_percentage(y_true, y_pred, interval, batch_sum=None):
    """Fraction of valid pixels with |err| <= 1 interval (loss.py:162-173)."""
    return _less_x_percentage(y_true, y_pred, interval, 1.0, batch_sum)


def less_three_percentage(y_true, y_pred, interval, batch_sum=None):
    """(reference: loss.py:176-187)"""
    return _less_x_percentage(y_true, y_pred, interval, 3.0, batch_sum)


def mvsnet_regression_loss(estimated_depth, depth_image, depth_start, depth_end,
                           loss_type: str = "original", alpha: float = 1.0,
                           beta: float = 0.0, eta: float = 0.02,
                           grad_loss: bool = True, batch_sum=None):
    """Loss, <1 and <3 interval metrics with the fixed (end - start) / 191
    interval (reference: loss.py:190-220). Returns (loss, less_one,
    less_three, debug), debug the gradient-loss term or 0. With
    `batch_sum`, loss and debug are this rank's shares and the metrics
    are the whole batch's."""
    depth_interval = (depth_end - depth_start) / 191.0
    if loss_type == "original":
        loss = original_loss(depth_image, estimated_depth, depth_interval)
    elif loss_type == "power":
        loss = power_loss(depth_image, estimated_depth, depth_interval, alpha, beta,
                          batch_sum=batch_sum)
    elif loss_type == "gaussian":
        loss = gaussian_loss(depth_image, estimated_depth, depth_interval, eta, batch_sum)
    else:
        raise NotImplementedError(loss_type)
    debug = torch.zeros((), dtype=torch.float32, device=estimated_depth.device)
    if grad_loss:
        debug = gradient_loss(depth_image, estimated_depth, batch_sum=batch_sum)
        loss = loss + 0.5 * debug
    with torch.no_grad():
        less_one = less_one_percentage(depth_image, estimated_depth, depth_interval,
                                       batch_sum)
        less_three = less_three_percentage(depth_image, estimated_depth, depth_interval,
                                           batch_sum)
    return loss, less_one, less_three, debug


def mvsnet_classification_loss(prob_volume, gt_depth_image, depth_num: int, depth_start,
                               depth_interval, batch_sum=None, rows=None, gather=None):
    """R-MVSNet's cross entropy and winner-take-all metrics (losses.py:161-195;
    reference: loss.py:223-267). prob_volume (B, D, H, W) softmax
    probabilities, gt_depth_image (B, H, W, 1), depth_start and
    depth_interval (B,). Returns (xent, masked_mae, less_one, less_three,
    wta_depth_map).

    The ground-truth plane is round((gt - start) / interval), half to even,
    clipped to [0, D - 1]; its log-probability log(max(p, 1e-20)) is picked
    with a one-hot product and a sum over D (a gather's backward would add
    with atomics on the card, in no fixed order). The winner-take-all plane
    is the first of equal maxima. xent and masked_mae are sums of per-map
    terms; with `batch_sum` (see above) the metrics' counts are the whole
    batch's. With `rows` (r0, r1) the prob volume holds those rows of the
    maps (B, D, r1 - r0, W), and `gather` takes a (B, r1 - r0, W, 1) map of
    per-pixel terms to the whole (B, H, W, 1); see the module docstring."""
    B, D = prob_volume.shape[:2]
    mask = (gt_depth_image != 0.0).to(torch.float32)
    valid = mask.sum(dim=(1, 2, 3)) + 1e-7
    start = depth_start.reshape(B, 1, 1, 1)
    interval = depth_interval.reshape(B, 1, 1, 1)
    mine = slice(None) if rows is None else slice(*rows)
    gt_index = torch.round(mask[:, mine] * ((gt_depth_image[:, mine] - start) / interval))
    gt_index = gt_index.to(torch.int32)[..., 0].clamp(0, depth_num - 1)   # (B, H, W)
    logp = torch.log(torch.clamp(prob_volume, min=1e-20))
    one_hot = (torch.arange(D, device=prob_volume.device)[None, :, None, None]
               == gt_index[:, None]).to(logp.dtype)
    picked = torch.sum(logp * one_hot, dim=1)
    xent_image = -picked[..., None] * mask[:, mine]
    if gather is not None:
        xent_image = gather(xent_image)
    xent = torch.sum(xent_image.sum(dim=(1, 2, 3)) / valid)
    with torch.no_grad():
        wta_index = torch.argmax(prob_volume, dim=1).to(torch.float32)[..., None]
        if gather is not None:
            wta_index = gather(wta_index)
        wta_depth = wta_index * interval + start
        abs_interval = torch.abs(interval.reshape(B))
        masked_mae = non_zero_mean_absolute_diff(gt_depth_image, wta_depth, abs_interval)
        less_one = less_one_percentage(gt_depth_image, wta_depth, abs_interval, batch_sum)
        less_three = less_three_percentage(gt_depth_image, wta_depth, abs_interval, batch_sum)
    return xent, masked_mae, less_one, less_three, wta_depth
