"""Fix converted DTU sessions: resize depths to 640x512 and apply the
1.171875 focal correction (a copy of tools/dtu_fixer.py; parity:
datasets/tools/dtu_fixer.py).

`python -m mvsnet_tpu_torch.tools.dtu_fixer <data_dir>`

cv2's read (IMREAD_ANYDEPTH), nearest resize and write become the port's
PNG decoder, `data.transforms.resize_nearest` (cv2's INTER_NEAREST taps,
bit for bit) and its PNG encoder: the same depth arrays.
"""

from __future__ import annotations

import argparse
import json
import os

from mvsnet_tpu_torch.data.transforms import resize_nearest
from mvsnet_tpu_torch.io import images

FOCAL_RESCALE = 1.171875
DEPTH_SIZE = (640, 512)          # width, height


def fix_depths(data_dir: str) -> None:
    sessions = [f for f in os.listdir(data_dir)
                if not f.startswith(".") and not f.endswith(".txt")]
    n = 0
    for s in sessions:
        if "dtu_scan" not in s:
            continue
        sdir = os.path.join(data_dir, s)
        depths_dir = os.path.join(sdir, "depths")
        for name in os.listdir(depths_dir):
            path = os.path.join(depths_dir, name)
            img = images.read_png(path)
            if img.ndim != 2:
                raise ValueError(f"{path}: a depth PNG has one channel, not {img.shape[2]}")
            images.write_png(path, resize_nearest(img, *DEPTH_SIZE))
        cameras_dir = os.path.join(sdir, "cameras")
        for c in os.listdir(cameras_dir):
            path = os.path.join(cameras_dir, c)
            with open(path) as f:
                data = json.load(f)
            data["intrinsics"]["fx"] *= FOCAL_RESCALE
            data["intrinsics"]["fy"] *= FOCAL_RESCALE
            with open(path, "w") as f:
                json.dump(data, f)
        n += 1
        if n % 20 == 0:
            print(f"Fixed {n} sessions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_dir")
    args = p.parse_args(argv)
    fix_depths(args.data_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
