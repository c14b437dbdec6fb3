"""Dataset conversion helpers (a copy of tools/convert_utils.py; reference:
datasets/convert/utils.py) on the port's IO.

Target format is the mvs-training session layout consumed by
mvsnet_tpu_torch.data (images/<i>.jpg, cameras/<i>.json, depths/<i>.png
uint16 mm, covisibility.json).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from mvsnet_tpu_torch.io.cams import load_cam_txt
from mvsnet_tpu_torch.io.images import write_depth_png
from mvsnet_tpu_torch.io.pfm import load_pfm


def depth_pfm_to_png(pfm_path: str, png_path: str) -> None:
    """(reference: datasets/convert/utils.py:9-13)"""
    depth = load_pfm(pfm_path)
    write_depth_png(png_path, depth)


def cam_to_json(txt_path: str, json_path: str, scale_factor: float = 1.0,
                px_extra_scale: float = 1.0) -> None:
    """MVSNet cam.txt -> camera.json; translation mm -> m
    (reference: datasets/convert/utils.py:16-46). px_extra_scale mirrors the
    0.94 crop fixup the reference hardcodes for DTU."""
    cam = load_cam_txt(txt_path, interval_scale=1.0, max_d=0)
    cam_json = {
        "intrinsics": {
            "fx": cam[1, 0, 0] * scale_factor,
            "fy": cam[1, 1, 1] * scale_factor,
            "px": cam[1, 0, 2] * scale_factor * px_extra_scale,
            "py": cam[1, 1, 2] * scale_factor,
        },
        "pose": {"matrix": {
            f"{r},{c}": (cam[0, r, c] / 1000.0 if c == 3 and r != 3 else cam[0, r, c])
            for r in range(4) for c in range(4)
        }},
    }
    with open(json_path, "w") as f:
        json.dump(cam_json, f)


def pair_to_covisibility(pair_path: str, output_path: str,
                         min_depth: float = 400.0, max_depth: float = 1000.0):
    """pair.txt -> covisibility.json (reference: utils.py:49-66)."""
    with open(pair_path) as f:
        lines = [line.strip() for line in f]
    covis = {}
    for i in range(2, len(lines), 2):
        data = lines[i].split()
        key = lines[i - 1]
        views = [int(data[j]) for j in range(1, len(data), 2)]
        covis[key] = {"views": views, "min_depth": min_depth, "max_depth": max_depth}
    with open(output_path, "w") as f:
        json.dump(covis, f)
    return covis


def image_name(image_index: int, lighting_index: int) -> str:
    return f"rect_{image_index + 1:03d}_{lighting_index}_r5000.png"


def depth_name(depth_index: int) -> str:
    return f"depth_map_{depth_index:04d}.pfm"


def cam_name(cam_index: int) -> str:
    return f"{cam_index:08d}_cam.txt"


def list_no_hidden(d: str):
    return [f for f in os.listdir(d) if not f.startswith(".")]


# -- DeMoN / DPSNet conversion (reference: utils.py:107-203) ---------------

def cameras_from_demon(d: str, scale_factor: float = 1.0) -> int:
    intrinsics = np.genfromtxt(os.path.join(d, "cam.txt"))
    poses = np.genfromtxt(os.path.join(d, "poses.txt"))
    if poses.ndim == 1:
        poses = poses[None]
    num_cams = poses.shape[0]
    camera_dir = os.path.join(d, "cameras")
    os.makedirs(camera_dir, exist_ok=True)
    for i in range(num_cams):
        mat = {f"{r},{c}": float(poses[i, r * 4 + c]) for r in range(3) for c in range(4)}
        mat.update({"3,0": 0.0, "3,1": 0.0, "3,2": 0.0, "3,3": 1.0})
        cam_json = {
            "intrinsics": {
                "fx": float(intrinsics[0, 0]) * scale_factor,
                "fy": float(intrinsics[1, 1]) * scale_factor,
                "px": float(intrinsics[0, 2]) * scale_factor,
                "py": float(intrinsics[1, 2]) * scale_factor,
            },
            "pose": {"matrix": mat},
        }
        with open(os.path.join(camera_dir, f"{i}.json"), "w") as f:
            json.dump(cam_json, f)
    return num_cams


def depths_from_demon(d: str):
    depth_paths = sorted(glob.glob(os.path.join(d, "*.npy")))
    depths_dir = os.path.join(d, "depths")
    os.makedirs(depths_dir, exist_ok=True)
    max_depth, min_depth = 0.0, 100000.0
    for i, p in enumerate(depth_paths):
        data = np.load(p) * 1000.0   # meters -> mm
        data = np.clip(data, 0, 65535).astype(np.uint16)
        write_depth_png(os.path.join(depths_dir, f"{i}.png"), data)
        nz = data[(data != 0) & (data != 65535)]
        if nz.size:
            max_depth = max(max_depth, float(nz.max()))
            min_depth = min(min_depth, float(nz.min()))
        os.remove(p)
    return len(depth_paths), min_depth, max_depth


def images_from_demon(d: str) -> int:
    image_paths = sorted(glob.glob(os.path.join(d, "*.jpg")))
    images_dir = os.path.join(d, "images")
    os.makedirs(images_dir, exist_ok=True)
    for i, p in enumerate(image_paths):
        os.rename(p, os.path.join(images_dir, f"{i}.jpg"))
    return len(image_paths)


def covisibility_from_demon(d: str, min_depth: float = 400.0,
                            max_depth: float = 65535.0) -> None:
    """All-views-covisible clusters, each image once as reference
    (reference: utils.py:185-203)."""
    num = len(glob.glob(os.path.join(d, "depths", "*.png")))
    covis = {
        str(i): {"views": [x for x in range(num) if x != i],
                 "min_depth": int(min_depth), "max_depth": int(max_depth)}
        for i in range(num)
    }
    with open(os.path.join(d, "covisibility.json"), "w") as f:
        json.dump(covis, f)
