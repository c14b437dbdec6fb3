"""Plain float32 reference of CasMVSNet (Gu et al., "Cascade Cost Volume
for High-Resolution Multi-View Stereo and Stereo Matching", CVPR 2020,
arXiv:1912.06378), the eval forward of its published model
(alibaba/cascade-stereo, CasMVSNet/models/{cas_mvsnet.py, module.py}):
the FPN tower ("fpn": 32 channels at H/4, 16 at H/2, 8 at H), then three
stages of 48, 32 and 8 depth planes at interval ratios 4, 2 and 1, each a
variance cost volume over its per-pixel planes, its own CostRegNet U-Net
(PyTorch's symmetric pads, `ConvTranspose3d(k3, s2, p1, output_padding
1)`), a softmax over the planes (the cost not negated), the depth
regression and the 4-plane confidence. The output is stage 3's depth and
confidence at the images' resolution.

Stage 1's planes are uniform over [depth_min, depth_max], depth_max =
depth_start + (D - 1) depth_interval, D the configuration's `max_d`; the
planes of stages 2 and 3 are centred on the stage before's depth resized
bilinearly to the images' size, spaced D_s r_s delta / (D_s - 1) with
delta = (depth_max - depth_min) / D, and resized trilinearly to the
stage's resolution, as the official forward forms them. One departure,
shared with the program (`departures` in the configuration): pixel
centres at +0.5 (K1's taps), where the official warp puts them on
integers.

Channels-first tensors; parameters under the program's state-dict names
and in its layouts (conv kernels (*k, Cin, Cout), transposed-conv kernels
flax-oriented: out[2i + t - 1] takes k[2 - t] x[i]). `cast` as in
`common`: applied wherever the program rounds to its compute dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mvs_bench.reference import common
from mvs_bench.reference.common import exact

# the published cascade: planes and interval ratios of stages 1, 2, 3
PLANES = (48, 32, 8)
RATIOS = (4, 2, 1)


def fpn_layers(base: int = 8):
    """(name, cin, cout, kernel, stride) of the tower's conv -> batch norm
    -> ReLU layers."""
    b = base
    return [("conv0_0", 3, b, 3, 1), ("conv0_1", b, b, 3, 1),
            ("conv1_0", b, 2 * b, 5, 2), ("conv1_1", 2 * b, 2 * b, 3, 1),
            ("conv1_2", 2 * b, 2 * b, 3, 1),
            ("conv2_0", 2 * b, 4 * b, 5, 2), ("conv2_1", 4 * b, 4 * b, 3, 1),
            ("conv2_2", 4 * b, 4 * b, 3, 1)]


def fpn_heads(base: int = 8):
    """(name, cin, cout, kernel, bias) of the tower's bare convs: the output
    of each level and the 1x1 laterals."""
    b = base
    return [("out1", 4 * b, 4 * b, 1, False), ("inner1", 2 * b, 4 * b, 1, True),
            ("inner2", b, 4 * b, 1, True), ("out2", 4 * b, 2 * b, 3, False),
            ("out3", 4 * b, b, 3, False)]


def regnet_layers(cin: int, base: int = 8):
    """(name, kind, cin, cout, stride) of CostRegNet: "convbn" 3x3x3 conv ->
    batch norm -> ReLU, "deconvbn" k3 s2 transposed conv -> batch norm ->
    ReLU, "conv" the bare 1-channel output conv."""
    b = base
    return [("conv0", "convbn", cin, b, 1), ("conv1", "convbn", b, 2 * b, 2),
            ("conv2", "convbn", 2 * b, 2 * b, 1), ("conv3", "convbn", 2 * b, 4 * b, 2),
            ("conv4", "convbn", 4 * b, 4 * b, 1), ("conv5", "convbn", 4 * b, 8 * b, 2),
            ("conv6", "convbn", 8 * b, 8 * b, 1), ("conv7", "deconvbn", 8 * b, 4 * b, 2),
            ("conv9", "deconvbn", 4 * b, 2 * b, 2), ("conv11", "deconvbn", 2 * b, b, 2),
            ("prob", "conv", b, 1, 1)]


def stage_channels(base: int = 8):
    """The feature channels of stages 1, 2, 3."""
    return (4 * base, 2 * base, base)


def _bn_specs(prefix, cout):
    return [(f"{prefix}bn.{stat}", (cout,), kind) for stat, kind in
            (("scale", "scale"), ("bias", "shift"), ("mean", "mean"), ("var", "var"))]


def param_specs(cfg: dict):
    """(name, shape, kind) of every parameter and batch-norm statistic;
    kinds as in `mvsnet.param_specs`, plus "bias" for the laterals' biases."""
    base = cfg["base_filters"]
    out = []
    for name, cin, cout, k, _ in fpn_layers(base):
        out.append((f"feature_net.{name}.conv.kernel", (k, k, cin, cout), "kernel"))
        out += _bn_specs(f"feature_net.{name}.", cout)
    for name, cin, cout, k, bias in fpn_heads(base):
        out.append((f"feature_net.{name}.kernel", (k, k, cin, cout), "kernel"))
        if bias:
            out.append((f"feature_net.{name}.bias", (cout,), "bias"))
    for s, c in enumerate(stage_channels(base)):
        for name, kind, cin, cout, _ in regnet_layers(c, base):
            prefix = f"regnet.stages.{s}.{name}."
            sub = {"convbn": "conv.", "deconvbn": "deconv.", "conv": ""}[kind]
            out.append((f"{prefix}{sub}kernel", (3, 3, 3, cin, cout), "kernel"))
            if kind != "conv":
                out += _bn_specs(prefix, cout)
    return out


# --- layers with PyTorch's symmetric padding --------------------------------

def conv(x, kernel, stride=1, bias=None, cast=exact):
    """Conv of rank 2 or 3 with padding k // 2 on every side: x (N, Cin,
    *sp), kernel (*k, Cin, Cout) -> (N, Cout, ...) float32, not cast."""
    rank = x.ndim - 2
    k = kernel.shape[0]
    w = cast(kernel).permute(rank + 1, rank, *range(rank))
    y = (F.conv3d if rank == 3 else F.conv2d)(cast(x), w, stride=stride, padding=k // 2)
    if bias is not None:
        y = y + bias.reshape(1, -1, *([1] * rank))
    return y


def deconv(x, kernel, cast=exact):
    """`ConvTranspose3d(k3, s2, padding 1, output_padding 1)`, output 2n per
    axis, on the flax-oriented kernel (*k, Cin, Cout)."""
    w = cast(kernel).flip([0, 1, 2]).permute(3, 4, 0, 1, 2)
    return F.conv_transpose3d(cast(x), w, stride=2, padding=1, output_padding=1)


def fpn(p, x, cast=exact, base: int = 8):
    """The FPN tower: images (N, 3, H, W) -> the features of stages 1, 2, 3,
    (N, 4b, H/4, W/4), (N, 2b, H/2, W/2), (N, b, H, W), each cast."""
    layers = {name: stride for name, _, _, _, stride in fpn_layers(base)}

    def cbr(name, t):
        y = conv(t, p[f"feature_net.{name}.conv.kernel"], layers[name], cast=cast)
        return cast(torch.relu(common.batch_norm(y, p, f"feature_net.{name}.bn.")))

    def head(name, t):
        return cast(conv(t, p[f"feature_net.{name}.kernel"],
                         bias=p.get(f"feature_net.{name}.bias"), cast=cast))

    def up2(t):
        return F.interpolate(t, scale_factor=2, mode="nearest")

    c0 = cbr("conv0_1", cbr("conv0_0", x))
    c1 = cbr("conv1_2", cbr("conv1_1", cbr("conv1_0", c0)))
    c2 = cbr("conv2_2", cbr("conv2_1", cbr("conv2_0", c1)))
    f1 = head("out1", c2)
    t = cast(up2(c2) + head("inner1", c1))
    f2 = head("out2", t)
    t = cast(up2(t) + head("inner2", c0))
    return f1, f2, head("out3", t)


def costregnet(p, x, stage: int, cast=exact, base: int = 8):
    """CostRegNet of `stage` (0, 1, 2): the volume (B, C, D, h, w) -> the
    cost (B, D, h, w), float32."""
    layers = {name: (kind, stride) for name, kind, _, _, stride
              in regnet_layers(stage_channels(base)[stage], base)}
    prefix = f"regnet.stages.{stage}."

    def run(name, t):
        kind, stride = layers[name]
        if kind == "conv":
            return conv(t, p[f"{prefix}{name}.kernel"], cast=cast)
        if kind == "convbn":
            y = conv(t, p[f"{prefix}{name}.conv.kernel"], stride, cast=cast)
        else:
            y = deconv(t, p[f"{prefix}{name}.deconv.kernel"], cast)
        return cast(torch.relu(common.batch_norm(y, p, f"{prefix}{name}.bn.")))

    x0 = run("conv0", x)
    x2 = run("conv2", run("conv1", x0))
    x4 = run("conv4", run("conv3", x2))
    x6 = run("conv6", run("conv5", x4))
    y = cast(x4 + run("conv7", x6))
    y = cast(x2 + run("conv9", y))
    y = cast(x0 + run("conv11", y))
    return cast(run("prob", y))[:, 0]


# --- planes, projections, the per-pixel cost volume, regression --------------

def depth_range(depth_start, depth_interval, D: int):
    """depth_min, depth_max and delta = (depth_max - depth_min) / D, each (B,)."""
    depth_max = depth_start + (D - 1) * depth_interval
    return depth_start, depth_max, (depth_max - depth_start) / D


def stage_planes(depth, stage: int, depth_start, depth_interval, D: int, H: int, W: int):
    """The (B, D_s, h_s, w_s) plane depths of `stage`, as the official
    forward forms them: uniform at stage 0; else centred on `depth` (B, h,
    w), the stage before's, resized bilinearly to H x W, then resized
    trilinearly to the stage's resolution."""
    Ds, ratio, scale = PLANES[stage], RATIOS[stage], 2 ** (2 - stage)
    lo, hi, delta = depth_range(depth_start, depth_interval, D)
    h, w = H // scale, W // scale
    if depth is None:
        k = torch.arange(Ds, dtype=torch.float32, device=lo.device)
        planes = lo[:, None] + k[None] * ((hi - lo) / (Ds - 1))[:, None]
        return planes[:, :, None, None].expand(-1, -1, h, w)
    cur = F.interpolate(depth[:, None], size=(H, W), mode="bilinear", align_corners=False)[:, 0]
    step = (ratio * delta)[:, None, None]
    k = torch.arange(Ds, dtype=torch.float32, device=cur.device)[None, :, None, None]
    full = (cur - Ds / 2 * step)[:, None] + k * (Ds * step / (Ds - 1))[:, None]
    return F.interpolate(full[:, None], size=(Ds, h, w), mode="trilinear",
                         align_corners=False)[:, 0]


def projections(cams, stage: int):
    """[M_v | b_v] (V-1, B, 3, 4): the top three rows of P_v P_ref^-1 with
    P = [[K R, K t], [0, 1]], the intrinsics' top two rows of the quarter
    cams times 2^stage."""
    cams = cams.clone()
    cams[:, :, 1, :2, :3] *= 2.0 ** stage
    K, E = cams[:, :, 1, :3, :3], cams[:, :, 0]
    P = E.clone()
    P[:, :, :3, :4] = K @ E[:, :, :3, :4]
    ref_inv = torch.linalg.inv(P[:, 0])
    return torch.stack([(P[:, v] @ ref_inv)[:, :3] for v in range(1, cams.shape[1])])


def pixel_warp(view, proj, planes):
    """view (B, C, h, w) sampled at each reference pixel p and plane k:
    q = M (p + 0.5) d_k(p) + b, bilinear at q_xy / q_z with zero fill ->
    (B, C, D, h, w)."""
    B, C, h, w = view.shape
    D = planes.shape[1]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=view.device) + 0.5,
                            torch.arange(w, dtype=torch.float32, device=view.device) + 0.5,
                            indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    rays = proj[:, :, :3] @ grid                                   # (B, 3, h*w)
    q = rays[:, None] * planes.reshape(B, D, 1, h * w) + proj[:, None, :, 3:]
    z = q[:, :, 2]
    z = torch.where(z.abs() < 1e-7, torch.where(z < 0, -1e-7, 1e-7), z)
    x = q[:, :, 0] / z - 0.5
    y = q[:, :, 1] / z - 0.5
    g = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1], dim=-1)
    out = F.grid_sample(view, g.reshape(B, D * h, w, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(B, C, D, h, w)


def cost_volume(ref, views, projs, planes):
    """Variance over the V views of each pixel's planes, the reference
    included: (B, C, D, h, w) float32."""
    D = planes.shape[1]
    s = ref[:, :, None].expand(-1, -1, D, -1, -1)
    s2 = s * s
    for view, proj in zip(views, projs):
        wv = pixel_warp(view, proj, planes)
        s, s2 = s + wv, s2 + wv * wv
    V = len(views) + 1
    mean = s / V
    return s2 / V - mean * mean


def regression(cost, planes):
    """cost (B, D, h, w) -> depth (B, h, w), the probability volume
    softmax(cost) over the planes, and the confidence: the probability of
    planes i - 1 .. i + 2, i = floor(sum_k P_k k) clamped to [0, D - 1]."""
    pvol = torch.softmax(cost, dim=1)
    depth = (pvol * planes).sum(1)
    k = torch.arange(cost.shape[1], dtype=torch.float32, device=cost.device)
    idx = (pvol * k[None, :, None, None]).sum(1).long()
    return depth, pvol, window_prob(pvol, idx)


def window_prob(pvol, idx):
    """Sum of pvol (B, D, h, w) over planes idx - 1 .. idx + 2 inside [0, D),
    idx (B, h, w) clamped to [0, D - 1] first."""
    D = pvol.shape[1]
    idx = idx.clamp(0, D - 1)
    total = torch.zeros_like(pvol[:, 0])
    for off in (-1, 0, 1, 2):
        j = idx + off
        got = torch.gather(pvol, 1, j.clamp(0, D - 1)[:, None])[:, 0]
        total = total + torch.where((j >= 0) & (j < D), got, torch.zeros_like(got))
    return total


def forward(p, images, cams, depth_start, depth_interval, D: int, cast=exact, base: int = 8):
    """images (B, V, H, W, 3), cams (B, V, 2, 4, 4) at the quarter scale,
    depth_start and depth_interval (B,), D the configuration's depth count
    -> per stage (depth (B, h, w), probability volume (B, D_s, h, w),
    planes (B, D_s, h, w), confidence (B, h, w)), stages 1 to 3."""
    B, V, H, W, _ = images.shape
    feats = fpn(p, cast(images.reshape(B * V, H, W, 3).permute(0, 3, 1, 2)), cast, base)
    depth, out = None, []
    for s, f in enumerate(feats):
        f = f.reshape(B, V, *f.shape[1:])
        planes = stage_planes(depth, s, depth_start, depth_interval, D, H, W)
        volume = cast(cost_volume(f[:, 0], [f[:, v] for v in range(1, V)],
                                  projections(cams, s), planes))
        cost = costregnet(p, volume, s, cast, base)
        depth, pvol, conf = regression(cost, planes)
        out.append((depth, pvol, planes, conf))
    return out


# --- serving ------------------------------------------------------------------

@torch.no_grad()
def serve_reference(p, requests, D: int, device, cast=exact):
    """For each request (images, cams, depth_start, depth_interval,
    depth_end), arrays with batch 1: stage 3's (depth (H, W), probability
    volume (8, H, W), planes (8, H, W), plane spacing, confidence (H, W))
    on `device`."""
    out = []
    for images, cams, ds, di, _ in requests:
        t = [torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
             for a in (images, cams, ds, di)]
        depth, pvol, planes, conf = forward(p, *t, D, cast=cast)[-1]
        spacing = PLANES[2] * RATIOS[2] * depth_range(t[2], t[3], D)[2] / (PLANES[2] - 1)
        out.append((depth[0], pvol[0], planes[0], spacing, conf[0]))
    return out


# the mean errors that are also judged against a faithful bfloat16 computation's
RATIO_KEYS = ("depth_err", "conf_err")


def _plane_index(depth, planes, spacing):
    """floor of `depth`'s position on the planes, in plane spacings."""
    return torch.floor((depth - planes[0]) / spacing).long()


@torch.no_grad()
def answer_errors(refs, answer, device) -> dict:
    """One answer (pool index, depth (H, W), confidence (H, W)) against the
    reference's stage 3: `depth_err`, the mean over its pixels of the gap
    between the program's depth and the reference's, in stage-3 plane
    spacings; `conf_err`, the mean gap between the program's confidence and
    the reference's probability volume summed over the four planes around
    the program's own depth placed on the reference's planes (so that a
    pixel near a plane boundary compares the same planes on both sides);
    `depth_gap` and `conf_gap`, the widest single pixel's. A non-finite
    answer reads inf."""
    idx, depth, conf = answer
    r_depth, r_pvol, r_planes, spacing, _ = refs[idx]
    d = torch.as_tensor(depth, dtype=torch.float32, device=device)
    c = torch.as_tensor(conf, dtype=torch.float32, device=device)
    if not (torch.isfinite(d).all() and torch.isfinite(c).all()):
        return dict.fromkeys(("depth_err", "conf_err", "depth_gap", "conf_gap"), math.inf)
    dd = (d - r_depth).abs() / spacing
    r_conf = window_prob(r_pvol[None], _plane_index(d, r_planes, spacing)[None])[0]
    dc = (c - r_conf).abs()
    return {"depth_err": float(dd.mean()), "conf_err": float(dc.mean()),
            "depth_gap": float(dd.max()), "conf_gap": float(dc.max())}


def control_answers(refs_low, pool_indices):
    """The control's answers in the program's form: the lower-precision
    reference's stage-3 depth and confidence."""
    out = []
    for idx in pool_indices:
        depth, *_, conf = refs_low[idx]
        out.append((idx, depth.cpu().numpy(), conf.cpu().numpy()))
    return out
