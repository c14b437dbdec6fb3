"""Split a directory of sessions into train/val/test subdirs (a copy of
tools/split_data.py).

`python -m mvsnet_tpu_torch.tools.split_data <data_dir> --train 0.9 --val 0.075 --test 0.025`
(parity: datasets/tools/split_data.py, with a --seed for reproducibility
and float-safe fraction validation).
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

import numpy as np


def split_data(data_dir: str, train: float, val: float, test: float,
               seed: int = 0) -> None:
    sessions = [f for f in os.listdir(data_dir)
                if not f.startswith(".") and not f.endswith(".txt")
                and os.path.isdir(os.path.join(data_dir, f))
                and f not in ("train", "val", "test")]
    num = len(sessions)
    num_train = int(np.floor(train * num))
    num_val = int(np.floor(val * num))
    random.Random(seed).shuffle(sessions)
    splits = {
        "train": sessions[:num_train],
        "val": sessions[num_train:num_train + num_val],
        "test": sessions[num_train + num_val:],
    }
    print(f"{num} total sessions")
    for name, group in splits.items():
        out = os.path.join(data_dir, name)
        os.makedirs(out, exist_ok=True)
        print(f"{len(group)} {name} sessions")
        for s in group:
            shutil.move(os.path.join(data_dir, s), os.path.join(out, s))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_dir")
    p.add_argument("--train", type=float, default=0.9)
    p.add_argument("--val", type=float, default=0.075)
    p.add_argument("--test", type=float, default=0.025)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if abs(args.train + args.val + args.test - 1.0) >= 1e-6:
        p.error("Train, val and test fractions must add up to 1!")
    split_data(args.data_dir, args.train, args.val, args.test, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
