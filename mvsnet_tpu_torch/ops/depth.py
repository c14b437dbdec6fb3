"""Depth regression: soft-argmin, the 2/4-bucket probability map and the
winner-take-all update (counterpart of mvsnet_tpu/ops/depth.py:20-182).

The JAX package leaves these to XLA, not to a Pallas kernel, so they are
plain PyTorch in float32 here.
"""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.ops.geometry import depth_values, inv_depth_values


def _per_batch(v, B, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device).expand(B)


def _samples(B, D, start, interval, end, inverse_depth, device):
    if inverse_depth:
        return inv_depth_values(start, _per_batch(end, B, device), D)
    return depth_values(start, interval, D)


def _bucket_indices(depth, start, interval, D, inverse_depth):
    """left0, right0 depth-axis indices around `depth` (B, H, W)
    (reference: model.py:45-107; inverse depth indexes in 1/depth space and
    flips back)."""
    startb = start[:, None, None]
    intervalb = interval[:, None, None]
    if inverse_depth:
        d_end = startb + (D - 1) * intervalb
        inv_start = 1.0 / startb
        inv_end = 1.0 / d_end
        inv_interval = (inv_start - inv_end) / (D - 1)
        inv_d = (1.0 / depth - inv_end) / inv_interval
        left0 = (D - torch.ceil(inv_d).to(torch.int64) - 1).clamp(0, D - 1)
        right0 = (D - torch.floor(inv_d).to(torch.int64) - 1).clamp(0, D - 1)
    else:
        d = (depth - startb) / intervalb
        left0 = torch.floor(d).to(torch.int64).clamp(0, D - 1)
        right0 = torch.ceil(d).to(torch.int64).clamp(0, D - 1)
    return left0, right0


def _bucket_weight(left0, right0, D, num_buckets, dtype):
    """Summed per-bucket indicators over the depth axis, (B, D, H, W); a
    bucket counted twice (floor == ceil) weighs twice, as in the reference."""
    iota = torch.arange(D, device=left0.device)[None, :, None, None]

    def indicator(idx):
        return (iota == idx[:, None]).to(dtype)

    weight = indicator(left0) + indicator(right0)
    if num_buckets == 4:
        weight = (weight + indicator((left0 - 1).clamp(0, D - 1))
                  + indicator((right0 + 1).clamp(0, D - 1)))
    return weight


def soft_argmin(reg_cost, depth_start, depth_interval, depth_num: int,
                inverse_depth: bool = False, depth_end=None):
    """reg_cost (B, D, H, W) -> depth (B, H, W, 1), softmax volume (B, D, H, W)."""
    B, D = reg_cost.shape[:2]
    if D != depth_num:
        raise ValueError(f"cost has {D} planes, expected {depth_num}")
    prob_volume = torch.softmax(-reg_cost.to(torch.float32), dim=1)
    dev = reg_cost.device
    start = _per_batch(depth_start, B, dev)
    interval = None if inverse_depth else _per_batch(depth_interval, B, dev)
    samples = _samples(B, D, start, interval, depth_end, inverse_depth, dev)
    depth = torch.sum(samples[:, :, None, None] * prob_volume, dim=1)
    return depth[..., None], prob_volume


def probability_map(prob_volume, depth_map, depth_start, depth_interval,
                    inverse_depth: bool = False, num_buckets: int = 4):
    """Summed probability of the 2 or 4 planes nearest the depth, (B, H, W, 1)."""
    if num_buckets not in (2, 4):
        raise ValueError(f"num_buckets must be 2 or 4, got {num_buckets}")
    B, D = prob_volume.shape[:2]
    dev = prob_volume.device
    depth = depth_map.to(torch.float32)[..., 0]
    left0, right0 = _bucket_indices(depth, _per_batch(depth_start, B, dev),
                                    _per_batch(depth_interval, B, dev), D,
                                    inverse_depth)
    weight = _bucket_weight(left0, right0, D, num_buckets, prob_volume.dtype)
    return torch.sum(prob_volume * weight, dim=1)[..., None]


def soft_argmin_prob_map(reg_cost, depth_start, depth_interval,
                         depth_num: int, inverse_depth: bool = False,
                         depth_end=None, num_buckets: int = 4):
    """Soft-argmin and probability map without the normalised softmax
    volume: the same as `probability_map(*soft_argmin(...))` up to rounding.
    Returns depth (B, H, W, 1), prob (B, H, W, 1), float32."""
    if num_buckets not in (2, 4):
        raise ValueError(f"num_buckets must be 2 or 4, got {num_buckets}")
    B, D = reg_cost.shape[:2]
    if D != depth_num:
        raise ValueError(f"cost has {D} planes, expected {depth_num}")
    x = -reg_cost.to(torch.float32)
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    s = e.sum(dim=1)
    dev = reg_cost.device
    start = _per_batch(depth_start, B, dev)
    interval = _per_batch(depth_interval, B, dev)
    samples = _samples(B, D, start, interval, depth_end, inverse_depth, dev)
    depth = torch.sum(e * samples[:, :, None, None], dim=1) / s
    left0, right0 = _bucket_indices(depth, start, interval, D, inverse_depth)
    weight = _bucket_weight(left0, right0, D, num_buckets, e.dtype)
    prob = torch.sum(e * weight, dim=1) / s
    return depth[..., None], prob[..., None]


def winner_take_all_update(carry, prob, depth_value):
    """One winner-take-all step (depth.py:161-182): carry (max_prob,
    depth_image, exp_sum), each (B, H, W, 1); prob (B, H, W, 1), the
    unnormalised exp(reg) of this plane; depth_value (B,), its depth.
    The test is strict, so on a tie the first plane keeps the pixel; the
    carry keeps its dtypes."""
    max_prob, depth_image, exp_sum = carry
    d_img = depth_value.reshape(-1, 1, 1, 1).to(depth_image.dtype).expand_as(depth_image)
    update = prob > max_prob
    return (torch.where(update, prob, max_prob), torch.where(update, d_img, depth_image),
            exp_sum + prob)
