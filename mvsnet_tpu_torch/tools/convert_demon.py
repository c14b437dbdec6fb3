"""DeMoN (DPSNet-formatted) -> mvs-training session converter (a copy of
tools/convert_demon.py).

`python -m mvsnet_tpu_torch.tools.convert_demon <demon_root>`
(parity: datasets/convert/demon_to_mvs_training.py: each subdirectory is
converted in place: cams/poses -> cameras/*.json, *.npy depths -> uint16 mm
PNGs, *.jpg -> images/, all-covisible clusters).

`python -m mvsnet_tpu_torch.tools.convert_demon --fix <demon_root>` cleans
CONVERTED data (parity: datasets/convert/demon_fixer.py:1-80): sessions
containing a uint8 depth image are deleted outright; for the rest, every
covisibility entry's min/max depth is recomputed from the depth PNGs
(ignoring the 0 / 65535 invalid codes, floored/ceiled at the reference's
400/10000 mm defaults), and sessions that fail to scan are removed. The
depth PNGs are read by the port's decoder at their own bit depth.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np

from mvsnet_tpu_torch.io.images import read_png
from mvsnet_tpu_torch.tools import convert_utils as utils


def convert_demon(root: str) -> None:
    sessions = [f for f in utils.list_no_hidden(root)
                if os.path.isdir(os.path.join(root, f))]
    for i, s in enumerate(sessions):
        d = os.path.join(root, s)
        try:
            utils.cameras_from_demon(d)
            n, min_depth, max_depth = utils.depths_from_demon(d)
            utils.images_from_demon(d)
            utils.covisibility_from_demon(d, min_depth=min_depth, max_depth=max_depth)
        except Exception as e:
            print(f"Failed to convert {d}: {e}")
        if i % 50 == 0:
            print(f"Converted {i}/{len(sessions)} sessions")


def fix_demon(root: str) -> None:
    """demon_fixer parity (datasets/convert/demon_fixer.py:21-70)."""
    sessions = [f for f in utils.list_no_hidden(root)
                if os.path.isdir(os.path.join(root, f))]
    for i, s in enumerate(sessions):
        sdir = os.path.join(root, s)
        try:
            dmin, dmax = 400, 10000
            contains_uint8 = False
            for p in sorted(glob.glob(os.path.join(sdir, "depths", "*.png"))):
                # the file's own bit depth: load_depth_png would cast to uint16
                # and hide the uint8 dtype this fixer exists to detect
                data = np.asarray(read_png(p))
                if data.dtype == np.uint8:
                    contains_uint8 = True
                valid_max = data[data != 65535]
                valid_min = data[data != 0]
                if valid_max.size:
                    dmax = max(dmax, int(valid_max.max()))
                if valid_min.size:
                    dmin = min(dmin, int(valid_min.min()))
            if contains_uint8:
                print(f"uint8 depth in cluster {sdir} — deleting cluster")
                shutil.rmtree(sdir)
                continue
            covis_path = os.path.join(sdir, "covisibility.json")
            with open(covis_path) as f:
                covis = json.load(f)
            for k in covis:
                covis[k]["min_depth"] = int(dmin)
                covis[k]["max_depth"] = int(dmax)
            with open(covis_path, "w") as f:
                json.dump(covis, f)
            if i % 25 == 0:
                print(f"Fixed {i} of {len(sessions)} sessions")
        except Exception as e:  # noqa: BLE001
            print(f"Failed to fix session {s} ({e}). Removing session")
            shutil.rmtree(sdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("demon_root")
    p.add_argument("--fix", action="store_true",
                   help="clean converted data (demon_fixer parity) instead of converting")
    args = p.parse_args(argv)
    if args.fix:
        fix_demon(args.demon_root)
    else:
        convert_demon(args.demon_root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
