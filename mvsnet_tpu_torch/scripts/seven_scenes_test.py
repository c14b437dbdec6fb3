"""Batch test-and-fuse over the canonical 7-Scenes test sessions, with the
port (a copy of scripts/seven_scenes_test.py; parity: scripts/7scenes_test.py).

`python -m mvsnet_tpu_torch.scripts.seven_scenes_test --data_root ../data/7scenes/test \
    --model_dir ... --ckpt_step ... [--device cpu]`; other arguments go to
`test_and_fuse`.
"""

from __future__ import annotations

import argparse
import os
import sys

from mvsnet_tpu_torch.scripts.test_and_fuse import main as taf_main

SEVEN_SCENES_SESSIONS = [
    "office_9_mvs_training",
    "fire_4_mvs_training",
    "redkitchen_14_mvs_training",
    "stairs_4_mvs_training",
    "chess_5_mvs_training",
    "heads_1_mvs_training",
    "pumpkin_7_mvs_training",
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", default="../data/7scenes/test")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--ckpt_step", default=None)
    p.add_argument("--device", default="cuda:0")
    args, extra = p.parse_known_args(argv)

    rc = 0
    for session in SEVEN_SCENES_SESSIONS:
        folder = os.path.join(args.data_root, session)
        if not os.path.isdir(folder):
            print(f"skipping missing session {folder}")
            continue
        taf_args = ["--test_folder_root", folder, "--device", args.device]
        if args.model_dir:
            taf_args += ["--model_dir", args.model_dir]
        if args.ckpt_step:
            taf_args += ["--ckpt_step", str(args.ckpt_step)]
        rc |= taf_main(taf_args + extra)
    return rc


if __name__ == "__main__":
    sys.exit(main())
