#!/usr/bin/env python
"""DTU-style point-cloud evaluation: accuracy / completeness / F-score (a
copy of tools/eval_pointcloud.py that reads PLYs with the port's io/ply).

The reference pipeline left cloud scoring to the external DTU Matlab kit
(reference README.md:83-99 quotes its acc/comp numbers); this makes the
metric a first-class in-repo tool so fused clouds (mvsnet_tpu_torch.fusion) can
be scored against ground truth without leaving the framework:

  accuracy     distances pred -> GT   (how correct is what we built)
  completeness distances GT -> pred   (how much of the truth we built)
  precision/recall @ tau, F-score     (Tanks-and-Temples style)
  chamfer      mean(acc) + mean(comp)

Inputs are PLY (mvsnet_tpu_torch.io.ply / fusion output) or .npy point arrays.
GT may optionally carry a bounding box margin to mask un-reconstructable
border regions, and both clouds can be voxel-downsampled for O(N log N)
evaluation of very large clouds.

Usage:
  python -m mvsnet_tpu_torch.tools.eval_pointcloud --pred fused.ply --gt gt.ply \
      [--threshold 2.0] [--voxel 0] [--max_points 2000000] [--percentile 90]

Prints one JSON line with all metrics (units = input units, mm for DTU).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mvsnet_tpu_torch.io.ply import read_ply


def _load_points(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        pts = np.load(path)
    else:
        pts, _ = read_ply(path)
    pts = np.asarray(pts, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"{path}: expected (N, 3) points, got {pts.shape}")
    return pts


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Keep one (mean) point per voxel — deterministic, order-independent."""
    if voxel <= 0 or len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    # lexicographic unique over the 3 int coordinates
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    keys = keys[order]
    pts = points[order]
    new_cell = np.ones(len(keys), bool)
    new_cell[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    cell_ids = np.cumsum(new_cell) - 1
    sums = np.zeros((cell_ids[-1] + 1, 3))
    np.add.at(sums, cell_ids, pts)
    counts = np.bincount(cell_ids).astype(np.float64)
    return sums / counts[:, None]


def _subsample(points: np.ndarray, max_points: int, seed: int = 0) -> np.ndarray:
    if max_points <= 0 or len(points) <= max_points:
        return points
    idx = np.random.default_rng(seed).choice(len(points), max_points,
                                             replace=False)
    return points[idx]


def _bbox_mask(points: np.ndarray, ref: np.ndarray, margin: float) -> np.ndarray:
    lo = ref.min(axis=0) - margin
    hi = ref.max(axis=0) + margin
    return ((points >= lo) & (points <= hi)).all(axis=1)


def evaluate_clouds(pred: np.ndarray, gt: np.ndarray, threshold: float = 2.0,
                    percentile: float = 90.0, bbox_margin: float = -1.0) -> dict:
    """Score `pred` against `gt`. bbox_margin >= 0 drops pred points outside
    the GT bounding box + margin before scoring accuracy (standard DTU
    practice: outside the scanned volume there is no truth to compare to)."""
    from scipy.spatial import cKDTree

    if bbox_margin >= 0 and len(pred) and len(gt):
        pred = pred[_bbox_mask(pred, gt, bbox_margin)]
    if len(pred) == 0 or len(gt) == 0:
        return {"error": "empty cloud", "pred_points": int(len(pred)),
                "gt_points": int(len(gt))}

    d_pred = cKDTree(gt).query(pred, k=1, workers=-1)[0]   # accuracy dists
    d_gt = cKDTree(pred).query(gt, k=1, workers=-1)[0]     # completeness dists

    precision = float((d_pred < threshold).mean())
    recall = float((d_gt < threshold).mean())
    fscore = (0.0 if precision + recall == 0
              else 2 * precision * recall / (precision + recall))
    return {
        "pred_points": int(len(pred)),
        "gt_points": int(len(gt)),
        "threshold": threshold,
        "accuracy_mean": float(d_pred.mean()),
        "accuracy_median": float(np.median(d_pred)),
        f"accuracy_p{int(percentile)}": float(np.percentile(d_pred, percentile)),
        "completeness_mean": float(d_gt.mean()),
        "completeness_median": float(np.median(d_gt)),
        f"completeness_p{int(percentile)}": float(np.percentile(d_gt, percentile)),
        "precision": precision,
        "recall": recall,
        "fscore": fscore,
        "chamfer": float(d_pred.mean() + d_gt.mean()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pred", required=True, help="fused cloud (.ply/.npy)")
    p.add_argument("--gt", required=True, help="ground-truth cloud (.ply/.npy)")
    p.add_argument("--threshold", type=float, default=2.0,
                   help="precision/recall distance threshold (input units)")
    p.add_argument("--voxel", type=float, default=0.0,
                   help="voxel size for downsampling both clouds (0 = off)")
    p.add_argument("--max_points", type=int, default=2_000_000,
                   help="random subsample cap per cloud (0 = off)")
    p.add_argument("--percentile", type=float, default=90.0)
    p.add_argument("--bbox_margin", type=float, default=-1.0,
                   help=">=0: drop pred points outside GT bbox + margin")
    args = p.parse_args(argv)

    pred = _subsample(voxel_downsample(_load_points(args.pred), args.voxel),
                      args.max_points)
    gt = _subsample(voxel_downsample(_load_points(args.gt), args.voxel),
                    args.max_points, seed=1)
    metrics = evaluate_clouds(pred, gt, args.threshold, args.percentile,
                              args.bbox_margin)
    print(json.dumps(metrics))
    return 1 if "error" in metrics else 0


if __name__ == "__main__":
    sys.exit(main())
