"""Legacy DTU-format dataset support (a copy of mvsnet_tpu/data/dtu.py).

Parity with the path-list generators and pair.txt parsing in reference
mvsnet/preprocess.py:358-579: the classic MVSNet DTU layout of
Cameras/<id>_cam.txt + pair.txt, Rectified/ images and Depths/ pfm maps,
with the canonical train/validation/evaluation scan splits.
"""

from __future__ import annotations

import os
from typing import List

# Canonical DTU splits (reference: preprocess.py:362-383; same sets used by
# gen_dtu_resized_path and gen_dtu_mvs_path).
TRAINING_SET = [2, 6, 7, 8, 14, 16, 18, 19, 20, 22, 30, 31, 36, 39, 41, 42, 44,
                45, 46, 47, 50, 51, 52, 53, 55, 57, 58, 60, 61, 63, 64, 65, 68,
                69, 70, 71, 72, 74, 76, 83, 84, 85, 87, 88, 89, 90, 91, 92, 93,
                94, 95, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 107, 108,
                109, 111, 112, 113, 115, 116, 119, 120, 121, 122, 123, 124, 125,
                126, 127, 128]
VALIDATION_SET = [3, 5, 17, 21, 28, 35, 37, 38, 40, 43, 56, 59, 66, 67, 82, 86,
                  106, 117]
EVALUATION_SET = [1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48, 49,
                  62, 75, 77, 110, 114, 118]

CLUSTER_FILE = "Cameras/pair.txt"


def parse_pair_txt(path: str) -> List[List[int]]:
    """Parse the classic pair.txt view-selection format
    (reference: preprocess.py:547-560): total count, then per ref image:
    index line + 'num_views v0 score0 v1 score1 ...' line.

    Returns, per reference index, the ordered covisible view indices.
    """
    with open(path) as f:
        words = f.read().split()
    total = int(words[0])
    pos = 1
    pairs = []
    for _ in range(total):
        _ref_index = int(words[pos]); pos += 1
        n = int(words[pos]); pos += 1
        views = []
        for _ in range(n):
            views.append(int(words[pos])); pos += 2  # skip score
        pairs.append(views)
    return pairs


def gen_dtu_resized_path(dtu_data_folder: str, mode: str = "training",
                         view_num: int = 3) -> List[List[str]]:
    """Sample list for preprocessed (resized) DTU: per (scan, lighting, ref)
    -> [ref_img, ref_cam, view_img, view_cam, ..., depth]
    (reference: preprocess.py:358-434)."""
    sample_list = []
    scans = TRAINING_SET if mode == "training" else VALIDATION_SET
    pairs = parse_pair_txt(os.path.join(dtu_data_folder, CLUSTER_FILE))
    for scan in scans:
        image_folder = os.path.join(dtu_data_folder, f"Rectified/scan{scan}_train")
        cam_folder = os.path.join(dtu_data_folder, "Cameras/train")
        depth_folder = os.path.join(dtu_data_folder, f"Depths/scan{scan}_train")
        lightings = range(7) if mode == "training" else [3]
        for p, views in enumerate(pairs):
            if len(views) < view_num - 1:
                continue
            for j in lightings:
                paths = []
                paths.append(os.path.join(image_folder, f"rect_{p + 1:03d}_{j}_r5000.png"))
                paths.append(os.path.join(cam_folder, f"{p:08d}_cam.txt"))
                for view in views[: view_num - 1]:
                    paths.append(os.path.join(
                        image_folder, f"rect_{view + 1:03d}_{j}_r5000.png"))
                    paths.append(os.path.join(cam_folder, f"{view:08d}_cam.txt"))
                paths.append(os.path.join(depth_folder, f"depth_map_{p:04d}.pfm"))
                sample_list.append(paths)
    return sample_list


def gen_pipeline_mvs_list(dense_folder: str, view_num: int = 3) -> List[List[str]]:
    """Sample list for an SfM-pipeline export: images/ + cams/ + pair.txt
    (reference: preprocess.py:547-579)."""
    image_folder = os.path.join(dense_folder, "images")
    cam_folder = os.path.join(dense_folder, "cams")
    pairs = parse_pair_txt(os.path.join(dense_folder, "pair.txt"))
    sample_list = []
    for p, views in enumerate(pairs):
        paths = []
        paths.append(os.path.join(image_folder, f"{p:08d}.jpg"))
        paths.append(os.path.join(cam_folder, f"{p:08d}_cam.txt"))
        for view in views[: view_num - 1]:
            paths.append(os.path.join(image_folder, f"{view:08d}.jpg"))
            paths.append(os.path.join(cam_folder, f"{view:08d}_cam.txt"))
        sample_list.append(paths)
    return sample_list
