"""Plain float32 reference of R-MVSNet's serving graph (Yao et al., CVPR
2019, arXiv:1902.10556): the MVSNet feature tower, the variance cost
volume one depth plane at a time, three convolutional GRU cells (16, 4
and 2 filters) and a 1-channel projection over the planes in order, and
the winner-take-all: the depth of the plane with the largest exp(reg),
the first on a tie, and prob = max exp(reg) / (sum exp(reg) + 1e-7).

Each cell: gates = conv3x3(cat(x, h)) + b split into reset and update,
each layer-normed (over channels and space, eps 1e-12, a scale and a
shift per channel) and squashed by a sigmoid; y = tanh(layernorm(conv3x3(
cat(x, reset * h)) + b)); h' = update * h + (1 - update) * y.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mvs_bench.reference import common
from mvs_bench.reference.common import exact

CELLS = (("conv_gru1", 16), ("conv_gru2", 4), ("conv_gru3", 2))
PREFIX = "gru_sweep.gru."


def param_specs(cfg: dict):
    """(name, shape, kind) of every parameter; kinds as in
    `mvsnet.param_specs`, plus "bias" for the cells' conv biases."""
    base = cfg["base_filters"]
    out = common.tower_specs(base=base)
    cin = 4 * base
    for cell, f in CELLS:
        for conv, cout in (("gates_conv", 2 * f), ("output_conv", f)):
            out.append((f"{PREFIX}{cell}.{conv}.kernel", (3, 3, cin + f, cout), "kernel"))
            out.append((f"{PREFIX}{cell}.{conv}.bias", (cout,), "bias"))
        for norm in ("reset_norm", "update_norm", "output_norm"):
            out.append((f"{PREFIX}{cell}.{norm}.scale", (f,), "scale"))
            out.append((f"{PREFIX}{cell}.{norm}.bias", (f,), "shift"))
        cin = f
    out.append((f"{PREFIX}prob_conv.kernel", (3, 3, cin, 1), "kernel"))
    out.append((f"{PREFIX}prob_conv.bias", (1,), "bias"))
    return out


def layer_norm(x, p, name):
    """Over channels and space of each sample, eps 1e-12."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(1, 2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + 1e-12)
    return y * p[name + ".scale"].reshape(1, -1, 1, 1) + p[name + ".bias"].reshape(1, -1, 1, 1)


def cell(p, name, x, h, cast):
    q = f"{PREFIX}{name}."
    gates = common.conv(torch.cat([x, h], dim=1), p[q + "gates_conv.kernel"],
                        bias=p[q + "gates_conv.bias"], cast=cast)
    reset, update = gates.chunk(2, dim=1)
    reset = cast(torch.sigmoid(cast(layer_norm(reset, p, q + "reset_norm"))))
    update = cast(torch.sigmoid(cast(layer_norm(update, p, q + "update_norm"))))
    y = common.conv(torch.cat([x, reset * h], dim=1), p[q + "output_conv.kernel"],
                    bias=p[q + "output_conv.bias"], cast=cast)
    y = cast(torch.tanh(cast(layer_norm(y, p, q + "output_norm"))))
    return update * h + cast((1 - update) * y)


@torch.no_grad()
def wta(p, images, cams, depth_start, depth_end, D: int, cast=exact):
    """images (B, V, H, W, 3), cams (B, V, 2, 4, 4) at the features' scale,
    depth_start and depth_end (B,) -> depth (B, h, w), prob (B, h, w) and
    every plane's reg (B, D, h, w)."""
    interval = (depth_end - depth_start) / (D - 1)
    samples = common.depth_samples(depth_start, interval, D)
    ref, views = common.features(p, images, cast)
    homs = common.homographies(cams, samples)
    B, _, h, w = ref.shape
    states = [ref.new_zeros((B, f, h, w)) for _, f in CELLS]
    regs = ref.new_empty((B, D, h, w))
    max_prob = ref.new_zeros((B, h, w))
    depth = ref.new_zeros((B, h, w))
    exp_sum = ref.new_zeros((B, h, w))
    for d in range(D):
        x = -cast(common.cost_volume(ref, views, homs[:, :, d:d + 1])[:, :, 0])
        for i, (name, _) in enumerate(CELLS):
            states[i] = cell(p, name, x, states[i], cast)
            x = states[i]
        reg = common.conv(x, p[PREFIX + "prob_conv.kernel"], bias=p[PREFIX + "prob_conv.bias"],
                          cast=cast)[:, 0]
        regs[:, d] = reg
        prob = torch.exp(reg)
        better = prob > max_prob
        max_prob = torch.where(better, prob, max_prob)
        depth = torch.where(better, samples[:, d, None, None], depth)
        exp_sum = exp_sum + prob
    return depth, max_prob / (exp_sum + 1e-7), regs


@torch.no_grad()
def serve_reference(p, requests, D: int, device, cast=exact, batch: int = 8):
    """For each request (images, cams, depth_start, depth_interval,
    depth_end), arrays with batch 1: (depth (h, w), prob (h, w), regs (D,
    h, w), depth_start, depth_end) on `device`; `batch` requests at a time."""
    out = []
    for i in range(0, len(requests), batch):
        chunk = requests[i:i + batch]
        t = [torch.cat([torch.as_tensor(np.asarray(r[k]), dtype=torch.float32, device=device)
                        for r in chunk]) for k in (0, 1, 2, 4)]
        depth, prob, regs = wta(p, t[0], t[1], t[2], t[3], D, cast)
        out += [(depth[b], prob[b], regs[b], t[2][b], t[3][b]) for b in range(len(chunk))]
    return out


# the mean errors that are also judged against a faithful bfloat16 computation's
RATIO_KEYS = ("reg_err", "prob_err", "logprob_err")


@torch.no_grad()
def answer_errors(refs, answer, device) -> dict:
    """One answer (pool index, depth (h, w), prob (h, w)) against the
    reference: `reg_err`, the mean over its pixels of the gap by which the
    reg of the plane the program chose lies below the reference's largest
    reg there (the winner-take-all's pick judged by the reference; a
    depth that is no plane's reads inf); `prob_err`, the mean gap between
    the program's probability map and the reference's; `logprob_err`, the
    mean gap between the log of the program's probability and the log of
    the reference's probability of the plane the program chose, exp(reg) /
    (sum exp(reg) + 1e-7) there (so a pick that flips at a near-tie is
    reg_err's to judge, and this one the probability's arithmetic); and
    `reg_gap`, `prob_gap`, `logprob_gap`, the widest single pixel's."""
    idx, depth, prob = answer
    _, r_prob, regs, ds, de = refs[idx]
    D = regs.shape[0]
    bad = dict.fromkeys(("reg_err", "prob_err", "logprob_err", "reg_gap", "prob_gap",
                         "logprob_gap"), math.inf)
    d = torch.as_tensor(depth, dtype=torch.float32, device=device)
    pr = torch.as_tensor(prob, dtype=torch.float32, device=device)
    if not (torch.isfinite(d).all() and torch.isfinite(pr).all()):
        return bad
    pos = (d - ds) / ((de - ds) / (D - 1))
    plane = torch.round(pos)
    if float((pos - plane).abs().max()) > 1e-2 or float(plane.min()) < 0 or \
            float(plane.max()) > D - 1:
        return bad
    picked = torch.gather(regs, 0, plane.long()[None])[0]
    gap = regs.amax(dim=0) - picked
    dp = (pr - r_prob).abs()
    lse = torch.logsumexp(regs, dim=0)
    r_logp = picked - lse - torch.log1p(1e-7 * torch.exp(-lse))
    dl = (torch.log(pr.clamp_min(1e-30)) - r_logp).abs()
    return {"reg_err": float(gap.mean()), "prob_err": float(dp.mean()),
            "logprob_err": float(dl.mean()), "reg_gap": float(gap.max()),
            "prob_gap": float(dp.max()), "logprob_gap": float(dl.max())}


def control_answers(refs_low, pool_indices):
    """The control's answers in the program's form."""
    return [(idx, refs_low[idx][0].cpu().numpy(), refs_low[idx][1].cpu().numpy())
            for idx in pool_indices]
