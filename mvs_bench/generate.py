"""The traffic generator: requests from a mix's
parameters (`traffic/<mix>.json`), a configuration's operating point and
the seed. The same seed gives the same arrays; every seed gives the same
shapes and sizes, so only the values change the work.

A request or batch is a cluster of V views seen by a ring rig (each view
turned by a yaw and a roll and moved along a baseline from the last, a
copy of `make_rig` from the port's bench), with cams scaled to the
features' quarter resolution, as the data plane hands them over, and a
depth range inside the mix's. Images are smooth texture plus fine noise,
normalised per image and channel (the data plane's `center_image`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_rig(view_num, width, height, depth_start, depth_interval, max_d,
             yaw_deg=4.0, roll_deg=1.0, baseline=60.0):
    """(V, 2, 4, 4) cams of a ring rig (a copy of
    `mvsnet_tpu_torch/bench.py:make_rig`)."""
    f = width * 1.2
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]])
    cams = np.zeros((view_num, 2, 4, 4), np.float32)
    for v in range(view_num):
        yaw = np.deg2rad(yaw_deg) * v
        roll = np.deg2rad(roll_deg) * v
        cy, sy = np.cos(yaw), np.sin(yaw)
        cr, sr = np.cos(roll), np.sin(roll)
        R = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]]) @ \
            np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        E = np.eye(4)
        E[:3, :3] = R
        E[0, 3] = baseline * v
        E[1, 3] = 0.3 * baseline * v
        cams[v, 0] = E
        cams[v, 1, :3, :3] = K
        cams[v, 1, 3] = [depth_start, depth_interval, max_d,
                         depth_start + (max_d - 1) * depth_interval]
    return cams


def quarter_cams(cams, scale=0.25):
    """The cams of images resized by `scale`, as the data plane scales them."""
    out = cams.copy()
    out[..., 1, :2, :3] *= scale
    return out


def _images(n, views, height, width, gen, device):
    """(n, V, H, W, 3) float32 on `device`: texture at 1/8 resolution
    upsampled, plus noise, normalised per image and channel."""
    low = torch.randn((n * views, 3, height // 8, width // 8), generator=gen, device=device)
    img = F.interpolate(low, size=(height, width), mode="bilinear", align_corners=False)
    img = img + 0.5 * torch.randn((n * views, 3, height, width), generator=gen, device=device)
    img = (img - img.mean(dim=(2, 3), keepdim=True)) / img.std(dim=(2, 3), keepdim=True)
    return img.permute(0, 2, 3, 1).reshape(n, views, height, width, 3)


def _clusters(mix, op, n, rng):
    """n cam rigs (n, V, 2, 4, 4) at the quarter scale, and their depth starts."""
    interval = mix["depth_interval_mm"] * op["interval_scale"]
    D = op["max_d"]
    lo = mix["depth_min_mm"]
    hi = max(lo, mix["depth_max_mm"] - (D - 1) * interval)
    rig = mix["rig"]
    cams, starts = [], []
    for _ in range(n):
        start = float(rng.uniform(lo, hi))
        cams.append(quarter_cams(make_rig(
            op["view_num"], op["width"], op["height"], start, interval, D,
            yaw_deg=rng.uniform(*rig["yaw_deg"]), roll_deg=rng.uniform(*rig["roll_deg"]),
            baseline=rng.uniform(*rig["baseline_mm"]))))
        starts.append(start)
    return np.stack(cams), np.array(starts, np.float32)


def serve_pool(mix: dict, op: dict, seed: int, device) -> list:
    """`mix["pool"]` distinct requests, each (images (1, V, H, W, 3), cams
    (1, V, 2, 4, 4), depth_start (1,), depth_interval (1,), depth_end
    (1,)) as host float32 arrays, as a serving driver holds them."""
    rng = np.random.default_rng(seed)
    n = mix["pool"]
    cams, _ = _clusters(mix, op, n, rng)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 62)))
    images = _images(n, op["view_num"], op["height"], op["width"], gen, device).cpu().numpy()
    out = []
    for i in range(n):
        row = cams[i, 0, 1, 3]
        out.append((images[i:i + 1], cams[i:i + 1], row[None, 0].copy(), row[None, 1].copy(),
                    row[None, 3].copy()))
    return out
