"""Depth regression: soft-argmin, the 2/4-bucket probability map and the
winner-take-all update (counterpart of mvsnet_tpu/ops/depth.py:20-182).

The JAX package leaves these to XLA, not to a Pallas kernel, so they are
plain PyTorch in float32 here. `soft_argmin_prob_map_sharded` is the
collective edition over a volume's depth slabs (multi-device runs): GSPMD's
collective softmax along D, written out.
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


def _bucket_weight(left0, right0, D, num_buckets, dtype, planes=None):
    """Summed per-bucket indicators over the depth axis, (B, D, H, W); a
    bucket counted twice (floor == ceil) weighs twice, as in the reference.
    `planes` (start, count): only those planes of the D, (B, count, H, W)."""
    p0, n = (0, D) if planes is None else planes
    iota = torch.arange(p0, p0 + n, device=left0.device)[None, :, None, None]

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


def soft_argmin_prob_map_sharded(reg_block, plane0: int, depth_start, depth_interval,
                                 depth_num: int, inverse_depth: bool = False, depth_end=None,
                                 num_buckets: int = 4, reduce_sum=None, reduce_max=None):
    """`soft_argmin_prob_map` of a volume whose depth planes lie in slabs
    over ranks: reg_block (B, Dl, H, W) holds the planes [plane0, plane0 +
    Dl) of depth_num. `reduce_max` and `reduce_sum` take a tensor to its
    maximum and sum over the ranks holding the other slabs (None: this rank
    holds them all); the sum's backward is the identity, since every rank
    uses the result alike (`Mesh.all_reduce_replicated`). Three
    collectives: the max of -reg; the sums of e and e * sample, each slab
    with its global samples; the sum of e * w over the buckets around the
    depth, by their global plane indices. Equal to the whole tail up to the
    order of the sums. Returns depth (B, H, W, 1), prob (B, H, W, 1)."""
    if num_buckets not in (2, 4):
        raise ValueError(f"num_buckets must be 2 or 4, got {num_buckets}")
    B, Dl = reg_block.shape[:2]
    D = depth_num
    if not 0 <= plane0 <= D - Dl:
        raise ValueError(f"planes [{plane0}, {plane0 + Dl}) do not fit {D} planes")
    x = -reg_block.to(torch.float32)
    with torch.no_grad():           # the result does not depend on it
        m = x.amax(dim=1, keepdim=True)
        if reduce_max is not None:
            m = reduce_max(m)
    e = torch.exp(x - m)
    dev = reg_block.device
    start = _per_batch(depth_start, B, dev)
    interval = _per_batch(depth_interval, B, dev)
    samples = _samples(B, D, start, interval, depth_end, inverse_depth, dev)[:, plane0:plane0 + Dl]
    sums = torch.stack([e.sum(dim=1), torch.sum(e * samples[:, :, None, None], dim=1)])
    if reduce_sum is not None:
        sums = reduce_sum(sums)
    s, depth = sums[0], sums[1] / sums[0]
    left0, right0 = _bucket_indices(depth, start, interval, D, inverse_depth)
    weight = _bucket_weight(left0, right0, D, num_buckets, e.dtype, planes=(plane0, Dl))
    prob = torch.sum(e * weight, dim=1)
    if reduce_sum is not None:
        prob = reduce_sum(prob)
    return depth[..., None], (prob / s)[..., None]


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
