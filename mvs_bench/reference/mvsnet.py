"""Plain float32 reference of MVSNet with 3D-CNN regularization (Yao et
al., ECCV 2018, arXiv:1804.02505): the eval forward to the depth and
probability maps, and the comparisons that decide a run's `correct`.

The parameters are a dict {name: tensor} under the names `param_specs`
gives; the benchmark makes them from the seed and hands the same dict to
the program. Everything the program derives from them (folded batch norms,
homographies) is worked out again here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mvs_bench.reference import common
from mvs_bench.reference.common import exact

def unet_layers(cin: int = 32, base: int = 8):
    """(name, kind, cin, cout, stride) of RegNetUS0: "convbn" 3x3x3 conv ->
    batch norm -> ReLU, "deconvbn" k3 s2 transposed conv -> batch norm ->
    ReLU, "conv" the bare 1-channel output conv."""
    b = base
    return [("3dconv1_0", "convbn", cin, 2 * b, 2), ("3dconv2_0", "convbn", 2 * b, 4 * b, 2),
            ("3dconv3_0", "convbn", 4 * b, 8 * b, 2), ("3dconv0_1", "convbn", cin, b, 1),
            ("3dconv1_1", "convbn", 2 * b, 2 * b, 1), ("3dconv2_1", "convbn", 4 * b, 4 * b, 1),
            ("3dconv3_1", "convbn", 8 * b, 8 * b, 1), ("3dconv4_0", "deconvbn", 8 * b, 4 * b, 2),
            ("3dconv5_0", "deconvbn", 4 * b, 2 * b, 2), ("3dconv6_0", "deconvbn", 2 * b, b, 2),
            ("3dconv6_2", "conv", b, 1, 1)]


def param_specs(cfg: dict):
    """(name, shape, kind) of every parameter and batch-norm statistic;
    kind is "kernel" (fan-in = all but the last axis), "scale", "shift",
    "mean" or "var"."""
    base = cfg["base_filters"]
    out = common.tower_specs(base=base)
    for name, kind, cin, cout, _ in unet_layers(4 * base, base):
        sub = {"convbn": "conv.", "deconvbn": "deconv.", "conv": ""}[kind]
        out.append((f"regnet.{name}.{sub}kernel", (3, 3, 3, cin, cout), "kernel"))
        if kind != "conv":
            for stat, k in (("scale", "scale"), ("bias", "shift"), ("mean", "mean"),
                            ("var", "var")):
                out.append((f"regnet.{name}.bn.{stat}", (cout,), k))
    return out


def unet(p, x, cast=exact, base: int = 8):
    """RegNetUS0: the volume (B, C, D, h, w) -> the regularized cost (B, D, h, w)."""
    layers = {name: (kind, stride) for name, kind, _, _, stride in unet_layers(4 * base, base)}

    def run(name, t):
        kind, stride = layers[name]
        if kind == "conv":
            return common.conv(t, p[f"regnet.{name}.kernel"], cast=cast)
        if kind == "convbn":
            y = common.conv(t, p[f"regnet.{name}.conv.kernel"], stride, cast=cast)
        else:
            y = common.deconv(t, p[f"regnet.{name}.deconv.kernel"], cast)
        return torch.relu(common.batch_norm(y, p, f"regnet.{name}.bn."))

    c1_0 = run("3dconv1_0", x)
    c2_0 = run("3dconv2_0", c1_0)
    c3_0 = run("3dconv3_0", c2_0)
    c0_1 = run("3dconv0_1", x)
    c1_1 = run("3dconv1_1", c1_0)
    c2_1 = run("3dconv2_1", c2_0)
    c3_1 = run("3dconv3_1", c3_0)
    c4_1 = run("3dconv4_0", c3_1) + c2_1
    c5_1 = run("3dconv5_0", c4_1) + c1_1
    c6_1 = run("3dconv6_0", c5_1) + c0_1
    return run("3dconv6_2", c6_1)[:, 0]


def forward(p, images, cams, depth_start, depth_interval, D: int, cast=exact):
    """images (B, V, H, W, 3), cams (B, V, 2, 4, 4) at the features'
    scale, depth_start and depth_interval (B,), D planes -> depth (B, h,
    w), the probability volume (B, D, h, w) and the probability map (B, h,
    w)."""
    ref, views = common.features(p, images, cast)
    homs = common.homographies(cams, common.depth_samples(depth_start, depth_interval, D))
    cost = cast(common.cost_volume(ref, views, homs))
    reg = unet(p, cost, cast)
    return common.soft_argmin(reg, depth_start, depth_interval)


# --- serving ------------------------------------------------------------------

@torch.no_grad()
def serve_reference(p, requests, D: int, device, cast=exact):
    """For each request (images, cams, depth_start, depth_interval,
    depth_end), arrays with batch 1: (depth (h, w), probability volume
    (D, h, w), depth_start, depth_interval) on `device`."""
    out = []
    for images, cams, ds, di, _ in requests:
        t = [torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
             for a in (images, cams, ds, di)]
        depth, pvol, _ = forward(p, *t, D, cast=cast)
        out.append((depth[0], pvol[0], t[2], t[3]))
    return out


# the mean errors that are also judged against a faithful bfloat16 computation's
RATIO_KEYS = ("depth_err", "prob_err")


@torch.no_grad()
def answer_errors(refs, answer, device) -> dict:
    """One answer (pool index, depth (h, w), prob (h, w)) against the
    reference: `depth_err`, the mean over its pixels of the gap between the
    program's depth and the reference's, in depth intervals; `prob_err`,
    the mean gap between the program's probability map and the
    reference's probability volume summed over the four planes around the
    program's own depth (so that a pixel whose soft-argmin sits at a plane
    boundary compares the same planes on both sides); `depth_gap` and
    `prob_gap`, the widest single pixel's. A non-finite answer reads inf."""
    idx, depth, prob = answer
    r_depth, r_pvol, ds, di = refs[idx]
    d = torch.as_tensor(depth, dtype=torch.float32, device=device)
    pr = torch.as_tensor(prob, dtype=torch.float32, device=device)
    if not (torch.isfinite(d).all() and torch.isfinite(pr).all()):
        return dict.fromkeys(("depth_err", "prob_err", "depth_gap", "prob_gap"), math.inf)
    dd = (d - r_depth).abs() / di
    dp = (pr - common.bucket_prob(r_pvol[None], d[None], ds, di)[0]).abs()
    return {"depth_err": float(dd.mean()), "prob_err": float(dp.mean()),
            "depth_gap": float(dd.max()), "prob_gap": float(dp.max())}


def control_answers(refs_low, pool_indices):
    """The control's answers in the program's form: the lower-precision
    reference's depth and its own probability map."""
    out = []
    for idx in pool_indices:
        depth, pvol, ds, di = refs_low[idx]
        prob = common.bucket_prob(pvol[None], depth[None], ds, di)[0]
        out.append((idx, depth.cpu().numpy(), prob.cpu().numpy()))
    return out
