"""DTU -> mvs-training session converter (a copy of tools/convert_dtu.py).

`python -m mvsnet_tpu_torch.tools.convert_dtu <dtu_dir> <output_dir>`
(parity: datasets/convert/dtu_to_mvs_training.py: per scan x 7 lightings,
49 views each, cams rescaled 512/1200 with the 0.94 principal-point crop
fixup; without the reference's hardcoded `index > 43` skip, exposed as
--start_scan instead). The rectified images (PNG or JPEG) are read by the
port's decoders and written as `images/<j>.jpg` by its JPEG encoder
(imageio's default: quality 75, 4:2:0).
"""

from __future__ import annotations

import argparse
import os

from mvsnet_tpu_torch.io import filesystem as fs
from mvsnet_tpu_torch.io import images
from mvsnet_tpu_torch.tools import convert_utils as utils


def convert_dtu(dtu_dir: str, output_dir: str, start_scan: int = 0,
                num_views: int = 49, num_lightings: int = 7) -> None:
    camera_dir = os.path.join(dtu_dir, "Cameras")
    depths_base = os.path.join(dtu_dir, "Depths")
    images_base = os.path.join(dtu_dir, "Rectified")
    pair_path = os.path.join(camera_dir, "pair.txt")
    scans = sorted(utils.list_no_hidden(images_base))
    print("Number of scans =", len(scans))
    for index, scan in enumerate(scans):
        if index < start_scan:
            continue
        print("Processing scan", index)
        for l in range(num_lightings):
            session_dir = os.path.join(output_dir, f"dtu_scan_{index}_lighting_{l}")
            for sub in ("images", "depths", "cameras"):
                os.makedirs(os.path.join(session_dir, sub), exist_ok=True)
            utils.pair_to_covisibility(
                pair_path, os.path.join(session_dir, "covisibility.json"))
            rescale = 512.0 / 1200.0
            for i in range(num_views):
                utils.cam_to_json(
                    os.path.join(camera_dir, utils.cam_name(i)),
                    os.path.join(session_dir, "cameras", f"{i}.json"),
                    scale_factor=rescale, px_extra_scale=0.94)
            for j in range(num_views):
                utils.depth_pfm_to_png(
                    os.path.join(depths_base, scan, utils.depth_name(j)),
                    os.path.join(session_dir, "depths", f"{j}.png"))
                src_img = os.path.join(images_base, scan, utils.image_name(j, l))
                dst_img = os.path.join(session_dir, "images", f"{j}.jpg")
                images.write_image(dst_img, images.decode_image(fs.read_bytes(src_img)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dtu_dir")
    p.add_argument("output_dir")
    p.add_argument("--start_scan", type=int, default=0)
    args = p.parse_args(argv)
    convert_dtu(args.dtu_dir, args.output_dir, args.start_scan)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
