"""The port's benchmark at the repository's `bench.py` operating points.

    python -m mvsnet_tpu_torch.bench [--metric 3dcnn|train|gru|train_gru|all]

  3dcnn: MVSNet 3D-CNN inference at 1152x864, D=192, 3 views, "normal",
         bfloat16, interval_scale 1.06, device-resident inputs
         (`bench.py:97-133`): depth maps per second, `vs_baseline` against
         the published 1 map per 4.7 s;
  train: one full train step (forward, backward, RMSprop update) at
         640x480, D=192, 3 views, "lite", bfloat16, power + gradient loss
         on a uniform random ground truth (`bench.py:173-219`): seconds
         per step, `vs_baseline` 0 (no published baseline);
  gru:   R-MVSNet winner-take-all serving at 1600x1184 (1600x1200 cut to
         a multiple of 32), D=256, 3 views, "normal", bfloat16,
         interval_scale 0.8 (`bench.py:135-170`): depth maps per second,
         `vs_baseline` against the published 1 map per 9.1 s;
  train_gru: one R-MVSNet train step (classification loss) at 640x480,
         D=192, 3 views, "lite", bfloat16, `TrainConfig()`'s defaults
         (`bench.py:221-266`): seconds per step, `vs_baseline` 0.
Each point runs a warm-up, then `iters` calls between two
`torch.cuda.synchronize()`, three times; the value is the median and
`spread_pct` the spread of the three over it. Each prints one JSON line
with `bench.py`'s metric name and fields, plus the card's name and power
limit as `nvidia-smi` reports them. It needs a CUDA card and fails without
one. Weights and inputs are seeded.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_3DCNN_MAPS_PER_SEC = 1.0 / 4.7
BASELINE_GRU_MAPS_PER_SEC = 1.0 / 9.1
# each point's metric, under `bench.py`'s name
METRICS = {"3dcnn": "depth_maps_per_sec_1152x864_d192_3dcnn",
           "train": "train_step_sec_640x480_d192_lite",
           "gru": "depth_maps_per_sec_1600x1184_d256_gru_wta",
           "train_gru": "train_step_sec_640x480_d192_gru_lite"}


def make_rig(view_num, width, height, depth_start, depth_interval, max_d,
             yaw_deg=4.0, roll_deg=1.0, baseline=60.0):
    """Realistic ring rig (rotations + mm baselines): exercises real warp
    bands instead of the identity homographies an all-same-cam rig gives
    (a copy of `bench.py:35-57`)."""
    f = width * 1.2
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]])
    cams = np.zeros((1, view_num, 2, 4, 4), np.float32)
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
        cams[0, v, 0] = E
        cams[0, v, 1, :3, :3] = K
        cams[0, v, 1, 3] = [depth_start, depth_interval, max_d,
                            depth_start + (max_d - 1) * depth_interval]
    return cams


def _quarter_cams(cams):
    """The data plane scales the cams by output_scale: features live at 1/4."""
    cams_s = cams.copy()
    cams_s[:, :, 1, :3, :3] *= 0.25
    cams_s[:, :, 1, 2, 2] = 1.0
    return cams_s


def inference_case(device, height=864, width=1152, max_d=192, network_mode="normal",
                   compute_dtype="bfloat16"):
    """The 3dcnn point's call: () -> (depth, prob), inputs on the device."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet, apply_forward_3dcnn

    view_num = 3
    cfg = ModelConfig(view_num=view_num, max_d=max_d, width=width, height=height,
                      interval_scale=1.06, network_mode=network_mode,
                      compute_dtype=compute_dtype)
    model = MVSNet(cfg, seed=0).to(device).eval()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((1, view_num, height, width, 3)).astype(np.float32)
    depth_start, depth_interval = 425.0, 2.5 * 1.06
    cams_s = _quarter_cams(make_rig(view_num, width, height, depth_start, depth_interval,
                                    max_d))
    args = tuple(torch.as_tensor(a, device=device) for a in
                 (images, cams_s, cams_s[:, 0, 1, 3, 0], cams_s[:, 0, 1, 3, 1]))

    @torch.inference_mode()
    def run():
        depth, prob, _ = apply_forward_3dcnn(model, *args)
        return depth, prob
    return run


def gru_case(device, height=1184, width=1600, max_d=256, network_mode="normal",
             compute_dtype="bfloat16"):
    """The gru point's call: () -> (depth, prob), inputs on the device."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet

    view_num = 3
    cfg = ModelConfig(view_num=view_num, max_d=max_d, width=width, height=height,
                      interval_scale=0.8, network_mode=network_mode, regularization="GRU",
                      compute_dtype=compute_dtype)
    model = MVSNet(cfg, seed=0).to(device).eval()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((1, view_num, height, width, 3)).astype(np.float32)
    depth_start, depth_interval = 425.0, 2.5 * 0.8
    cams_s = _quarter_cams(make_rig(view_num, width, height, depth_start, depth_interval,
                                    max_d))
    args = tuple(torch.as_tensor(a, device=device) for a in
                 (images, cams_s, cams_s[:, 0, 1, 3, 0], cams_s[:, 0, 1, 3, 1]))

    @torch.inference_mode()
    def run():
        return model.forward_gru_wta(*args)
    return run


def train_case(device, height=480, width=640, max_d=192, network_mode="lite",
               compute_dtype="bfloat16", regularization="3DCNN"):
    """The train point's call (the train_gru point's with "GRU"): () ->
    metrics of one full train step."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet

    view_num = 3
    cfg = ModelConfig(view_num=view_num, max_d=max_d, width=width, height=height,
                      network_mode=network_mode, regularization=regularization,
                      compute_dtype=compute_dtype)
    tcfg = (TrainConfig() if regularization == "GRU" else
            TrainConfig(loss_type="power", grad_loss=True))
    model = MVSNet(cfg, seed=0)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((1, view_num, height, width, 3)).astype(np.float32)
    depth_start, depth_interval = 425.0, 2.5
    cams_s = _quarter_cams(make_rig(view_num, width, height, depth_start, depth_interval,
                                    max_d))
    h, w = height // 4, width // 4
    gt = rng.uniform(depth_start, depth_start + 190 * depth_interval,
                     (1, h, w, 1)).astype(np.float32)
    gt_full = rng.uniform(depth_start, depth_start + 190 * depth_interval,
                          (1, height, width, 1)).astype(np.float32)
    batch = train_lib.to_device((images, cams_s, gt, gt_full), device)
    state = train_lib.create_train_state(model, cfg, tcfg, device=device)
    step = train_lib.make_train_step(model, cfg, tcfg)

    def run():
        return step(state, batch)[1]
    return run


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def timed(run, iters: int, reps: int = 3):
    """(median seconds per call, samples): after a warm-up, `iters` calls
    between two synchronizes, `reps` times."""
    run()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / iters)
    return float(np.median(samples)), samples


def _spread_pct(samples):
    m = float(np.median(samples))
    return round(100.0 * (max(samples) - min(samples)) / m, 1) if m > 0 else 0.0


def _record(metric, value, unit, vs_baseline, samples, iters):
    name, limit = (p.strip() for p in card().split(",", 1))
    return {"metric": metric, "value": value, "unit": unit, "vs_baseline": vs_baseline,
            "spread_pct": _spread_pct(samples), "samples_s": samples, "iters": iters,
            "card": name, "power_limit": limit}


def bench_3dcnn(device, iters: int = 5) -> dict:
    dt, samples = timed(inference_case(device), iters)
    return _record(METRICS["3dcnn"], round(1.0 / dt, 4), "maps/s",
                   round((1.0 / dt) / BASELINE_3DCNN_MAPS_PER_SEC, 3), samples, iters)


def bench_train(device, iters: int = 3) -> dict:
    dt, samples = timed(train_case(device), iters)
    return _record(METRICS["train"], round(dt, 4), "s/step", 0.0, samples, iters)


def bench_gru(device, iters: int = 3) -> dict:
    dt, samples = timed(gru_case(device), iters)
    return _record(METRICS["gru"], round(1.0 / dt, 4), "maps/s",
                   round((1.0 / dt) / BASELINE_GRU_MAPS_PER_SEC, 3), samples, iters)


def bench_train_gru(device, iters: int = 3) -> dict:
    dt, samples = timed(train_case(device, regularization="GRU"), iters)
    return _record(METRICS["train_gru"], round(dt, 4), "s/step", 0.0, samples, iters)


POINTS = {"3dcnn": bench_3dcnn, "train": bench_train, "gru": bench_gru,
          "train_gru": bench_train_gru}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--metric", default="3dcnn", choices=sorted(POINTS) + ["all"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("mvsnet_tpu_torch.bench: no CUDA device; the benchmark times the card",
              file=sys.stderr)
        return 1
    from mvsnet_tpu_torch.ops.kernels import _lib

    _lib.build_all()
    device = torch.device("cuda", 0)
    for name in sorted(POINTS) if args.metric == "all" else [args.metric]:
        print(json.dumps(POINTS[name](device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
