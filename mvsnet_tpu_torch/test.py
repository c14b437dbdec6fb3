"""Benchmark driver: `python -m mvsnet_tpu_torch.test --input_dir <sessions> ...`
(counterpart of mvsnet_tpu/test.py; reference: mvsnet/test.py:22-192).

Runs inference on the sessions under `<input_dir>/test`, which have
ground-truth depths, and reports the loss, <1px and <3px per cluster and
averaged, appending the averages to a results CSV (`--results_path`);
`--write_output` also writes each cluster's maps as the infer driver does.
A depth map below the ground truth's resolution (no refinement, or
refinement at the cost volume's) is resized to it bilinearly first
(`ops/resize.py`, JAX's `jax.image.resize`). The JAX driver's flags, plus
`--device` (`cuda:0` by default; `cpu` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from mvsnet_tpu_torch import predict as pl
from mvsnet_tpu_torch.data import batch_iterator
from mvsnet_tpu_torch.infer import (add_device_arguments, leads, make_predictor,
                                    model_config_from_args)
from mvsnet_tpu_torch.losses import mvsnet_regression_loss
from mvsnet_tpu_torch.ops.resize import resize_bilinear
from mvsnet_tpu_torch.utils.logging import setup_logger
from mvsnet_tpu_torch.utils.paths import mkdir_p

logger = setup_logger("mvsnet_tpu_torch.test")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--ckpt_step", type=int, default=None)
    p.add_argument("--view_num", type=int, default=4)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--sample_scale", type=float, default=0.25)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--base_image_size", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--regularization", default="3DCNN", choices=["3DCNN", "GRU"])
    p.add_argument("--refinement", action="store_true")
    p.add_argument("--inverse_depth", action="store_true")
    p.add_argument("--network_mode", default="normal")
    p.add_argument("--refinement_network", default="unet")
    p.add_argument("--upsample_before_refinement", action="store_true")
    p.add_argument("--refine_with_confidence", action="store_true")
    p.add_argument("--grad_loss", action="store_true", default=True)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--write_output", action="store_true")
    p.add_argument("--max_clusters_per_session", type=int, default=100)
    p.add_argument("--results_path", default="./results.csv")
    p.add_argument("--compute_dtype", default="bfloat16")
    add_device_arguments(p)
    return p


def benchmark_depth_maps(input_dir, args):
    """The per-cluster loss, <1px, <3px and debug lists (test.py:60-125;
    reference: test.py:89-157)."""
    mcfg = model_config_from_args(args)
    gen = pl.setup_data_iterator(input_dir, mcfg, benchmark=True,
                                 max_clusters_per_session=args.max_clusters_per_session)
    predictor = make_predictor(mcfg, args)
    dev = predictor.device
    upsample_to_gt = not (args.refinement and args.upsample_before_refinement)

    losses, less_ones, less_threes, debugs = [], [], [], []
    n = len(gen.clusters)
    # the metrics are read every cluster; the PNG / PFM encodes still
    # overlap the next cluster's compute on the writer thread
    with pl.AsyncOutputWriter() as writer:
        for step, batch in enumerate(batch_iterator(gen.iterate_once(), args.batch_size)):
            (scaled_images, input_images, scaled_cams, full_cams, full_depth,
             indices, session_dirs) = batch
            ds, di, dn, de = pl.depth_params_from_cams(scaled_cams)
            t0 = time.time()
            depth, prob, residual = predictor.predict(input_images, scaled_cams, ds, di, de,
                                                      fetch=False)
            gt = torch.as_tensor(full_depth, dtype=torch.float32, device=dev)
            if upsample_to_gt:
                depth = resize_bilinear(depth, *gt.shape[1:3])
            start, end = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (ds, de))
            loss, l1, l3, dbg = mvsnet_regression_loss(depth, gt, start, end,
                                                       grad_loss=args.grad_loss)
            loss, l1, l3, dbg = float(loss), float(l1), float(l3), float(dbg)
            logger.info("depth inference %d/%d done. Image index %d. loss=%.4f "
                        "<1px=%.4f <3px=%.4f (%.3f sec/step)", step, n,
                        int(indices[0]), loss, l1, l3, time.time() - t0)
            if args.write_output and leads():
                write_dir = os.path.join(str(session_dirs[0]), "depths_mvsnet")
                mkdir_p(write_dir)
                writer.write(write_dir, depth, prob, scaled_images, scaled_cams,
                             full_cams, input_images, indices,
                             residuals=residual, upsample=not upsample_to_gt,
                             sample_scale=args.sample_scale, visualize=args.visualize)
            losses.append(loss)
            less_ones.append(l1)
            less_threes.append(l3)
            debugs.append(dbg)
    return losses, less_ones, less_threes, debugs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    losses, less_ones, less_threes, debugs = benchmark_depth_maps(args.input_dir, args)
    if not losses:
        logger.warning("No clusters benchmarked")
        return 1
    avg_loss = float(np.mean(losses))
    avg_l1 = float(np.mean(less_ones))
    avg_l3 = float(np.mean(less_threes))
    avg_dbg = float(np.mean(debugs))
    logger.info(" ** Average Loss = %s", avg_loss)
    logger.info(" ** Average Less one = %s", avg_l1)
    logger.info(" ** Average Less three = %s", avg_l3)
    if leads():
        pl.write_results(args.results_path, args.model_dir, args.ckpt_step,
                         avg_loss, avg_l1, avg_l3, avg_dbg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
