"""End-to-end: inference -> fusion -> collect PLYs [-> Sketchfab], with the
port (a copy of scripts/test_and_fuse.py).

`python -m mvsnet_tpu_torch.scripts.test_and_fuse --test_folder_root <sessions>
--model_dir ... [--device cpu] [--infer_args ...]` (parity:
scripts/test_and_fuse.py:1-84; inference and fusion run in this process on
`--device`, cuda:0 unless given 'cpu'; `--infer_args` goes to
`mvsnet_tpu_torch.infer`; the Sketchfab upload is opt-in via --sketchfab +
SKETCHFAB_API_TOKEN).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from mvsnet_tpu_torch.scripts import utils as ut


def write_results(args, urls):
    try:
        with open(args.results_path, "a+") as f:
            f.write(f"{args.model_dir}, {args.ckpt_step}, {urls}, "
                    f"{args.prob_threshold}, {args.disp_threshold}, "
                    f"{args.num_consistent} \n")
    except OSError as e:
        print(f"Failed to write results: {e}")


def test_and_fuse(args, dense_folder, ply_folder):
    if not args.no_test:
        ut.test(dense_folder, args.ckpt_step, args.model_dir,
                extra_args=args.infer_args, device=args.device)
    if args.test_only:
        return []
    ut.clear_old_points(dense_folder)
    ut.fuse(dense_folder, args.prob_threshold, args.disp_threshold,
            args.num_consistent, device=args.device)
    ply_paths = ut.get_fusion_plys(dense_folder)
    urls = ut.handle_plys(ply_paths, dense_folder, ply_folder, args)
    write_results(args, urls)
    return urls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt_step", default=None)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--test_folder_root", required=True)
    p.add_argument("--prob_threshold", type=float, default=0.8)
    p.add_argument("--ply_folder", default="./fused-point-clouds")
    p.add_argument("--disp_threshold", type=float, default=0.25)
    p.add_argument("--num_consistent", type=int, default=3)
    p.add_argument("--no_test", action="store_true")
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--sketchfab", action="store_true")
    p.add_argument("--results_path", default="./fusion_results.csv")
    p.add_argument("--device", default="cuda:0",
                   help="where inference and fusion run: the card, or 'cpu' for the plain "
                        "path")
    p.add_argument("--infer_args", nargs=argparse.REMAINDER, default=[],
                   help="extra args forwarded to mvsnet_tpu_torch.infer")
    args = p.parse_args(argv)

    dir_name = (f"{int(time.time())}_prob_{args.prob_threshold}"
                f"_disp_{args.disp_threshold}_consis_{args.num_consistent}")
    ply_folder = os.path.join(args.ply_folder, dir_name)
    os.makedirs(ply_folder, exist_ok=True)
    print(f"Final PLY files will be written to {ply_folder}")

    all_urls = []
    root = args.test_folder_root
    if os.path.isfile(os.path.join(root, "covisibility.json")):
        all_urls.append(test_and_fuse(args, root, ply_folder))
    else:
        for d in sorted(os.listdir(root)):
            dense = os.path.join(root, d)
            if not os.path.isdir(dense):
                continue
            try:
                all_urls.append(test_and_fuse(args, dense, ply_folder))
            except Exception as e:
                print(f"Failed to test and fuse on {dense}: {e}")
    write_results(args, all_urls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
