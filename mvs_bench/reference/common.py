"""Plain float32 building blocks of the MVSNet family, in PyTorch.

Channels-first tensors (N, C, *spatial), flax-oriented parameters: conv
kernels (*k, Cin, Cout), transposed-conv kernels (*k, Cin, Cout) as flax's
`ConvTranspose` holds them. Every function follows the published
description (TF "SAME" padding, zero-filled bilinear warps with pixel
centres at +0.5, the variance cost volume with the reference view
included, the soft-argmin and its 4-plane probability map) and imports
nothing of the system under test.

`cast` is applied wherever the measured program rounds to its compute
dtype (a conv's input, kernel and output, the images, the features, the
cost volume, the GRU's norms and gates): `exact` keeps float32, `bf16`
rounds to bfloat16, the configurations' stated compute precision, and
`fp8` through float8 e4m3 with a per-tensor scale, the precision below
it that a faster path would take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F8_MAX = 448.0      # the largest float8 e4m3 value


def no_tf32() -> None:
    """Float32 products in float32: TF32 would round their inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact(x):
    return x


def fp8(x):
    """x rounded to float8 e4m3 under one scale for the whole tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def bf16(x):
    """x rounded to bfloat16."""
    return x.to(torch.bfloat16).to(x.dtype)


def same_pads(n: int, k: int, s: int):
    """TF "SAME": output ceil(n / s); the low pad is half the total, rounded down."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, kernel, stride=1, bias=None, cast=exact):
    """SAME conv of rank 2 or 3: x (N, Cin, *sp), kernel (*k, Cin, Cout)."""
    rank = x.ndim - 2
    pads = [same_pads(n, k, stride) for n, k in zip(x.shape[2:], kernel.shape[:rank])]
    x = F.pad(cast(x), [p for lo_hi in reversed(pads) for p in lo_hi])
    w = cast(kernel).permute(rank + 1, rank, *range(rank))
    y = (F.conv3d if rank == 3 else F.conv2d)(x, w, stride=stride)
    if bias is not None:
        y = y + bias.reshape(1, -1, *([1] * rank))
    return cast(y)


def deconv(x, kernel, cast=exact):
    """flax `ConvTranspose(k3, s2, "SAME")`: out[2i + d] += k[2 - d] x[i] on
    every spatial axis, output 2n: x (N, Cin, *sp), kernel (*k, Cin, Cout)."""
    rank = x.ndim - 2
    w = cast(kernel).flip(list(range(rank))).permute(rank, rank + 1, *range(rank))
    y = (F.conv_transpose3d if rank == 3 else F.conv_transpose2d)(cast(x), w, stride=2)
    return cast(y[(..., *(slice(0, 2 * n) for n in x.shape[2:]))])


def group_norm(x, scale, bias, groups: int, eps: float):
    """Group norm over channels in `groups` consecutive groups and all
    spatial axes, two-pass statistics."""
    N, C = x.shape[:2]
    g = x.reshape(N, groups, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = torch.square(g - mean).mean(dim=2, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.ndim - 2)
    return y * scale.reshape(shape) + bias.reshape(shape)


def batch_norm(x, p, prefix, eps=1e-5):
    """flax BatchNorm on channels in eval: the running statistics."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mean, var = p[prefix + "mean"], p[prefix + "var"]
    y = (x - mean.reshape(shape)) * torch.rsqrt(var + eps).reshape(shape)
    return y * p[prefix + "scale"].reshape(shape) + p[prefix + "bias"].reshape(shape)


# --- the 2D feature tower shared by MVSNet and R-MVSNet (UNetDS2GN) ---------

def tower_layers(base: int = 8):
    """(name, kind, cin, cout, kernel, stride, relu) of UNetDS2GN: "convgn"
    conv -> group norm (8 channels a group) -> ReLU, "deconvgn" transposed
    conv -> group norm, "conv" a bare conv."""
    b = base
    return [
        ("2dconv1_0", "convgn", 3, 2 * b, 3, 2, True),
        ("2dconv2_0", "convgn", 2 * b, 4 * b, 3, 2, True),
        ("2dconv3_0", "convgn", 4 * b, 8 * b, 3, 2, True),
        ("2dconv4_0", "convgn", 8 * b, 16 * b, 3, 2, True),
        ("2dconv0_1", "convgn", 3, b, 3, 1, True),
        ("2dconv0_2", "convgn", b, b, 3, 1, True),
        ("2dconv1_1", "convgn", 2 * b, 2 * b, 3, 1, True),
        ("2dconv1_2", "convgn", 2 * b, 2 * b, 3, 1, True),
        ("2dconv2_1", "convgn", 4 * b, 4 * b, 3, 1, True),
        ("2dconv2_2", "convgn", 4 * b, 4 * b, 3, 1, True),
        ("2dconv3_1", "convgn", 8 * b, 8 * b, 3, 1, True),
        ("2dconv3_2", "convgn", 8 * b, 8 * b, 3, 1, True),
        ("2dconv4_1", "convgn", 16 * b, 16 * b, 3, 1, True),
        ("2dconv4_2", "convgn", 16 * b, 16 * b, 3, 1, True),
        ("2dconv5_0", "deconvgn", 16 * b, 8 * b, 3, 2, False),
        ("2dconv5_1", "convgn", 16 * b, 8 * b, 3, 1, True),
        ("2dconv5_2", "convgn", 8 * b, 8 * b, 3, 1, True),
        ("2dconv6_0", "deconvgn", 8 * b, 4 * b, 3, 2, False),
        ("2dconv6_1", "convgn", 8 * b, 4 * b, 3, 1, True),
        ("2dconv6_2", "convgn", 4 * b, 4 * b, 3, 1, True),
        ("2dconv7_0", "deconvgn", 4 * b, 2 * b, 3, 2, False),
        ("2dconv7_1", "convgn", 4 * b, 2 * b, 3, 1, True),
        ("2dconv7_2", "convgn", 2 * b, 2 * b, 3, 1, True),
        ("2dconv8_0", "deconvgn", 2 * b, b, 3, 2, False),
        ("2dconv8_1", "convgn", 2 * b, b, 3, 1, True),
        ("2dconv8_2", "convgn", b, b, 3, 1, True),
        ("conv9_0", "convgn", b, 2 * b, 5, 2, True),
        ("conv9_1", "convgn", 2 * b, 2 * b, 3, 1, True),
        ("conv9_2", "convgn", 2 * b, 2 * b, 3, 1, True),
        ("conv10_0", "convgn", 2 * b, 4 * b, 5, 2, True),
        ("conv10_1", "convgn", 4 * b, 4 * b, 3, 1, True),
        ("conv10_2", "conv", 4 * b, 4 * b, 3, 1, False),
    ]


def tower_specs(prefix: str = "feature_net.", base: int = 8):
    """(name, shape, kind) of the tower's parameters; kinds as in `mvsnet.param_specs`."""
    out = []
    for name, kind, cin, cout, k, _, _ in tower_layers(base):
        sub = {"convgn": "conv.", "deconvgn": "deconv.", "conv": ""}[kind]
        out.append((f"{prefix}{name}.{sub}kernel", (k, k, cin, cout), "kernel"))
        if kind != "conv":
            out.append((f"{prefix}{name}.gn.scale", (cout,), "scale"))
            out.append((f"{prefix}{name}.gn.bias", (cout,), "shift"))
    return out


def tower(p, x, cast=exact, prefix: str = "feature_net.", base: int = 8):
    """UNetDS2GN: images (N, 3, H, W) -> features (N, 4 base, H/4, W/4)."""
    layers = {name: (kind, stride, relu) for name, kind, _, _, _, stride, relu
              in tower_layers(base)}

    def run(name, t):
        kind, stride, relu = layers[name]
        if kind == "deconvgn":
            y = deconv(t, p[f"{prefix}{name}.deconv.kernel"], cast)
        else:
            sub = "conv." if kind == "convgn" else ""
            y = conv(t, p[f"{prefix}{name}.{sub}kernel"], stride, cast=cast)
        if kind != "conv":
            C = y.shape[1]
            y = group_norm(y, p[f"{prefix}{name}.gn.scale"], p[f"{prefix}{name}.gn.bias"],
                           max(1, C // 8), 1e-5)
        return torch.relu(y) if relu else y

    c1_0 = run("2dconv1_0", x)
    c2_0 = run("2dconv2_0", c1_0)
    c3_0 = run("2dconv3_0", c2_0)
    c4_0 = run("2dconv4_0", c3_0)
    c0_2 = run("2dconv0_2", run("2dconv0_1", x))
    c1_2 = run("2dconv1_2", run("2dconv1_1", c1_0))
    c2_2 = run("2dconv2_2", run("2dconv2_1", c2_0))
    c3_2 = run("2dconv3_2", run("2dconv3_1", c3_0))
    c4_2 = run("2dconv4_2", run("2dconv4_1", c4_0))
    c5_0 = run("2dconv5_0", c4_2)
    c5_2 = run("2dconv5_2", run("2dconv5_1", torch.cat([c5_0, c3_2], dim=1)))
    c6_0 = run("2dconv6_0", c5_2)
    c6_2 = run("2dconv6_2", run("2dconv6_1", torch.cat([c6_0, c2_2], dim=1)))
    c7_0 = run("2dconv7_0", c6_2)
    c7_2 = run("2dconv7_2", run("2dconv7_1", torch.cat([c7_0, c1_2], dim=1)))
    c8_0 = run("2dconv8_0", c7_2)
    c8_2 = run("2dconv8_2", run("2dconv8_1", torch.cat([c8_0, c0_2], dim=1)))
    c9_2 = run("conv9_2", run("conv9_1", run("conv9_0", c8_2)))
    return run("conv10_2", run("conv10_1", run("conv10_0", c9_2)))


def features(p, images, cast=exact):
    """images (B, V, H, W, 3) channels-last -> (ref (B, C, h, w), [view (B, C, h, w)])."""
    B, V, H, W, _ = images.shape
    f = tower(p, cast(images.reshape(B * V, H, W, 3).permute(0, 3, 1, 2)), cast)
    f = cast(f).reshape(B, V, *f.shape[1:])
    return f[:, 0], [f[:, v] for v in range(1, V)]


# --- plane-sweep geometry and the variance cost volume ----------------------

def homographies(cams, depths):
    """cams (B, V, 2, 4, 4), view 0 the reference; depths (B, D) ->
    (V-1, B, D, 3, 3), mapping reference pixel coordinates (centres at
    +0.5) to a source view's at each fronto-parallel depth:
    K_v R_v (I - (c_v - c_0) n^T / d) R_0^T K_0^-1, n the reference's axis."""
    ref = cams[:, 0]
    R0, t0, K0 = ref[:, 0, :3, :3], ref[:, 0, :3, 3:4], ref[:, 1, :3, :3]
    R0T = R0.transpose(-1, -2)
    c0 = -R0T @ t0
    left = (R0T @ torch.linalg.inv(K0))[:, None]
    eye = torch.eye(3, dtype=cams.dtype, device=cams.device)
    out = []
    for v in range(1, cams.shape[1]):
        Rv, tv, Kv = cams[:, v, 0, :3, :3], cams[:, v, 0, :3, 3:4], cams[:, v, 1, :3, :3]
        cv = -Rv.transpose(-1, -2) @ tv
        outer = (cv - c0) @ R0[:, 2:3, :]
        middle = eye[None, None] - outer[:, None] / depths[:, :, None, None]
        out.append((Kv @ Rv)[:, None] @ (middle @ left))
    return torch.stack(out)


def warp(view, homs):
    """view (B, C, h, w) sampled at every reference pixel through homs (B,
    D, 3, 3): bilinear, taps outside the map read 0 -> (B, C, D, h, w)."""
    B, C, h, w = view.shape
    D = homs.shape[1]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=view.dtype, device=view.device) + 0.5,
                            torch.arange(w, dtype=view.dtype, device=view.device) + 0.5,
                            indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    uvw = homs @ grid                                          # (B, D, 3, h*w)
    z = uvw[:, :, 2]
    z = torch.where(z.abs() < 1e-7, torch.where(z < 0, -1e-7, 1e-7), z)
    x = uvw[:, :, 0] / z - 0.5                                 # pixel coords, centres at integers
    y = uvw[:, :, 1] / z - 0.5
    g = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1], dim=-1)
    out = F.grid_sample(view, g.reshape(B, D * h, w, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(B, C, D, h, w)


def cost_volume(ref, views, homs):
    """Variance over the V views at each depth, the reference included:
    (B, C, D, h, w) float32."""
    D = homs.shape[2]
    s = ref[:, :, None].expand(-1, -1, D, -1, -1)
    s2 = s * s
    for view, h in zip(views, homs):
        wv = warp(view, h)
        s, s2 = s + wv, s2 + wv * wv
    V = len(views) + 1
    mean = s / V
    return s2 / V - mean * mean


def depth_samples(depth_start, depth_interval, D: int):
    """(B, D) depths start + i * interval."""
    i = torch.arange(D, dtype=depth_start.dtype, device=depth_start.device)
    return depth_start[:, None] + i[None] * depth_interval[:, None]


def soft_argmin(reg, depth_start, depth_interval):
    """reg (B, D, h, w) -> depth (B, h, w), the probability volume
    softmax(-reg) over depth (B, D, h, w), and the 4-plane probability map
    (B, h, w): the summed probability of planes floor(i) - 1, floor(i),
    ceil(i), ceil(i) + 1 around the depth's index i (a plane counted twice
    where floor = ceil)."""
    D = reg.shape[1]
    pvol = torch.softmax(-reg, dim=1)
    depth = (pvol * depth_samples(depth_start, depth_interval, D)[:, :, None, None]).sum(1)
    return depth, pvol, bucket_prob(pvol, depth, depth_start, depth_interval)


def bucket_prob(pvol, depth, depth_start, depth_interval):
    """The 4-plane probability map of `pvol` around `depth` (see `soft_argmin`)."""
    D = pvol.shape[1]
    idx = (depth - depth_start[:, None, None]) / depth_interval[:, None, None]
    lo = torch.floor(idx).long().clamp(0, D - 1)
    hi = torch.ceil(idx).long().clamp(0, D - 1)
    total = 0
    for k in (lo, hi, (lo - 1).clamp(0, D - 1), (hi + 1).clamp(0, D - 1)):
        total = total + torch.gather(pvol, 1, k[:, None])[:, 0]
    return total
