"""Depth-map visualization: `python -m mvsnet_tpu_torch.visualize <file>`
(counterpart of mvsnet_tpu/visualize.py).

Displays or saves .pfm/.dmb/.npy/.png depth maps
(parity: mvsnet/visualize.py:1-42). matplotlib is imported by `main`
only: `load_depth_any` runs where it is not installed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def load_depth_any(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        from mvsnet_tpu_torch.io.pfm import load_pfm
        return np.asarray(load_pfm(path))
    if ext == ".dmb":
        from mvsnet_tpu_torch.io.dmb import read_dmb
        return np.asarray(read_dmb(path))
    if ext == ".npy":
        return np.load(path)
    if ext == ".png":
        from mvsnet_tpu_torch.io.images import load_depth_png
        return load_depth_png(path).astype(np.float32)
    raise ValueError(f"unsupported depth format: {ext}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("depth_path")
    p.add_argument("--save", default=None,
                   help="save the rendering to this image path instead of showing")
    p.add_argument("--cmap", default="viridis")
    args = p.parse_args(argv)

    depth = np.squeeze(load_depth_any(args.depth_path))
    valid = depth > 0
    lo = float(depth[valid].min()) if valid.any() else 0.0
    hi = float(depth[valid].max()) if valid.any() else 1.0
    print(f"value range: {lo} .. {hi}")

    import matplotlib
    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 8))
    plt.imshow(np.where(valid, depth, np.nan), cmap=args.cmap, vmin=lo, vmax=hi)
    plt.colorbar(label="depth")
    plt.title(os.path.basename(args.depth_path))
    if args.save:
        plt.savefig(args.save, dpi=120, bbox_inches="tight")
        print(f"saved to {args.save}")
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
