"""Helpers of the test-and-fuse pipeline (a copy of scripts/utils.py; parity:
the reference's scripts/utils.py). Inference and fusion run in this process
through the port's drivers (`infer.main`, `fusion.main`) on `device`."""

from __future__ import annotations

import os
import shutil
from shutil import copyfile


def _device_args(device, args):
    return [] if device is None or "--device" in args else ["--device", str(device)]


def test(dense_folder, ckpt_step=None, model_dir=None, extra_args=(), device=None):
    """Inference on a session dir (reference: scripts/utils.py:13-16):
    `infer.main`'s return code."""
    from mvsnet_tpu_torch import infer

    args = ["--input_dir", dense_folder]
    if ckpt_step is not None:
        args += ["--ckpt_step", ckpt_step]
    if model_dir is not None:
        args += ["--model_dir", model_dir]
    args += list(extra_args)
    args += _device_args(device, args)
    return infer.main([str(a) for a in args])


def fuse(dense_folder, prob_threshold=0.1, disp_threshold=0.1, num_consistent=2, device=None):
    """The port's fusion (reference: scripts/utils.py:19-22, minus the
    fusibile path): `fusion.main`'s return code."""
    from mvsnet_tpu_torch import fusion

    args = ["--dense_folder", dense_folder, "--prob_threshold", prob_threshold,
            "--disp_threshold", disp_threshold, "--num_consistent", num_consistent]
    args += _device_args(device, args)
    return fusion.main([str(a) for a in args])


def clear_old_points(dense_folder):
    points_dir = os.path.join(dense_folder, "points_mvsnet")
    if os.path.isdir(points_dir):
        shutil.rmtree(points_dir)


def get_fusion_plys(dense_folder):
    """(reference: scripts/utils.py:31-39)"""
    ply_paths = []
    points_dir = os.path.join(dense_folder, "points_mvsnet")
    if not os.path.isdir(points_dir):
        return ply_paths
    for d in os.listdir(points_dir):
        if "consistencyCheck" in d:
            p = os.path.join(points_dir, d, "final3d_model.ply")
            if os.path.exists(p):
                ply_paths.append(p)
    return ply_paths


def handle_plys(ply_paths, dense_folder, ply_folder, args):
    """Copy fused PLYs to the collection dir; optionally publish to
    Sketchfab when an API token is configured
    (reference: scripts/utils.py:42-62)."""
    name = os.path.basename(os.path.normpath(dense_folder)) or "model"
    urls = []
    desc = (f"Prob threshold: {args.prob_threshold}, Disp threshold: "
            f"{args.disp_threshold}, Num consistent: {args.num_consistent}")
    for p in ply_paths:
        try:
            if getattr(args, "sketchfab", False):
                from mvsnet_tpu_torch.scripts import sketchfab
                urls.append(sketchfab.upload(p, name=name, description=desc))
            copyfile(p, os.path.join(ply_folder, name + ".ply"))
        except Exception as e:
            print(f"Failed to upload/copy ply {p}: {e}")
    return urls
