"""Camera IO: MVSNet cam.txt and Ubiquity6 camera.json formats (a copy of
mvsnet_tpu/io/cams.py).

The in-memory representation is the (2, 4, 4) "cam tensor"
(reference: mvs_cluster.py:91-111):
  cam[0]          4x4 world->camera extrinsic (t in mm)
  cam[1][:3,:3]   intrinsic K
  cam[1][3]       [depth_start, depth_interval, depth_num, depth_end]
"""

from __future__ import annotations

import json

import numpy as np

from mvsnet_tpu_torch.io.filesystem import open_file


def load_cam_txt(path_or_file, interval_scale: float = 1.0, max_d: int | None = None):
    """Parse MVSNet cam.txt, handling the 29/30/31-word variants
    (reference: preprocess.py:116-155)."""
    if isinstance(path_or_file, (str, bytes)):
        with open_file(path_or_file) as f:
            words = f.read().split()
    else:
        text = path_or_file.read()
        if isinstance(text, bytes):
            text = text.decode("utf-8")
        words = text.split()

    cam = np.zeros((2, 4, 4), dtype=np.float64)
    for i in range(4):
        for j in range(4):
            cam[0, i, j] = float(words[4 * i + j + 1])
    for i in range(3):
        for j in range(3):
            cam[1, i, j] = float(words[3 * i + j + 18])

    n = len(words)
    if n == 29:
        cam[1, 3, 0] = float(words[27])
        cam[1, 3, 1] = float(words[28]) * interval_scale
        cam[1, 3, 2] = float(max_d) if max_d is not None else 0.0
        cam[1, 3, 3] = cam[1, 3, 0] + cam[1, 3, 1] * cam[1, 3, 2]
    elif n == 30:
        cam[1, 3, 0] = float(words[27])
        cam[1, 3, 1] = float(words[28]) * interval_scale
        cam[1, 3, 2] = float(words[29])
        cam[1, 3, 3] = cam[1, 3, 0] + cam[1, 3, 1] * cam[1, 3, 2]
    elif n == 31:
        cam[1, 3, 0] = float(words[27])
        cam[1, 3, 1] = float(words[28]) * interval_scale
        cam[1, 3, 2] = float(words[29])
        cam[1, 3, 3] = float(words[30])
    return cam


def write_cam_txt(path, cam) -> None:
    """Write the cam tensor as cam.txt (reference: mvs_data_generation/utils.py:174-194)."""
    cam = np.asarray(cam)
    with open_file(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(cam[0, i, j]) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam[1, i, j]) for j in range(3)) + " \n")
        f.write("\n" + " ".join(str(cam[1, 3, j]) for j in range(4)) + "\n")


def cam_from_camera_json(camera_data: dict, min_depth: float, max_depth: float,
                         depth_num: int, interval_scale: float = 1.0):
    """Build a cam tensor from a U6 session camera.json dict
    (reference: mvs_cluster.py:91-127). Translation meters -> mm x1000."""
    cam = np.zeros((2, 4, 4), dtype=np.float64)
    pose = camera_data["pose"]["matrix"]
    for i in range(4):
        for j in range(4):
            cam[0, i, j] = pose[f"{i},{j}"]
    cam[0, 0:3, 3] *= 1000.0

    intr = camera_data["intrinsics"]
    cam[1, 0, 0] = intr["fx"]
    cam[1, 1, 1] = intr["fy"]
    cam[1, 0, 2] = intr["px"]
    cam[1, 1, 2] = intr["py"]
    cam[1, 2, 2] = 1.0

    depth_interval = ((max_depth - min_depth) / (depth_num - 1)) * interval_scale
    cam[1, 3, 0] = min_depth
    cam[1, 3, 1] = depth_interval
    cam[1, 3, 2] = depth_num
    cam[1, 3, 3] = max_depth
    return cam


def load_camera_json(path, min_depth, max_depth, depth_num, interval_scale=1.0):
    with open_file(path) as f:
        data = json.load(f)
    return cam_from_camera_json(data, min_depth, max_depth, depth_num, interval_scale)


def projection_matrix(cam):
    """3x4 P = K_hat @ E used by Gipuma-format export (reference: depthfusion.py:76-98)."""
    cam = np.asarray(cam)
    intrinsic = np.zeros((4, 4))
    intrinsic[:3, :3] = cam[1, :3, :3]
    return (intrinsic @ cam[0])[0:3, :]
