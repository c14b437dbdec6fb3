"""Inference driver: `python -m mvsnet_tpu_torch.infer --input_dir <session(s)> ...`
(counterpart of mvsnet_tpu/infer.py; reference: mvsnet/inference.py:18-146).

Computes depth and probability maps, refined with `--refinement`, for one
session dir (a dir with a `covisibility.json`) or every session dir under
`--input_dir`, and writes them to `<session>/depths_mvsnet/` (or
`--output_dir`): PFMs, depth and confidence PNGs, the reference image and
its cam (`predict.write_output`), on a writer thread while the card
computes the next cluster. `--cascade` serves CasMVSNet instead. The JAX
driver's flags, plus `--device`
(`cuda:0` by default; `cpu` runs the plain PyTorch path). With
`--num_devices N` > 1 the driver runs as N ranks, one process a card
(`torchrun --nproc_per_node=N -m mvsnet_tpu_torch.infer ...`); every rank
reads the sessions and rank 0 writes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from mvsnet_tpu_torch import predict as pl
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.data import batch_iterator
from mvsnet_tpu_torch.parallel.launch import init_from_env
from mvsnet_tpu_torch.utils.logging import setup_logger
from mvsnet_tpu_torch.utils.paths import mkdir_p

logger = setup_logger("mvsnet_tpu_torch.infer")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--ckpt_step", type=int, default=None)
    p.add_argument("--view_num", type=int, default=8)
    p.add_argument("--max_d", type=int, default=256)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--sample_scale", type=float, default=0.25)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--base_image_size", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--regularization", default="3DCNN", choices=["3DCNN", "GRU"])
    p.add_argument("--refinement", action="store_true")
    p.add_argument("--inverse_depth", action="store_true")
    p.add_argument("--network_mode", default="normal")
    p.add_argument("--refinement_network", default="original")
    p.add_argument("--upsample_before_refinement", action="store_true")
    p.add_argument("--refine_with_confidence", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--max_clusters_per_session", type=int, default=None)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--cascade", action="store_true",
                   help="serve CasMVSNet (48, 32 and 8 planes at full resolution)")
    add_device_arguments(p)
    return p


def add_device_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num_devices", type=int, default=None,
                   help="serve over N ranks, one process a card (torchrun)")
    p.add_argument("--device", default="cuda:0",
                   help="the card to run on, or 'cpu' for the plain PyTorch path; inside "
                        "a process group each rank takes its own card")


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(
        view_num=args.view_num, max_d=args.max_d, width=args.width,
        height=args.height, sample_scale=args.sample_scale,
        interval_scale=args.interval_scale, base_image_size=args.base_image_size,
        inverse_depth=args.inverse_depth, regularization=args.regularization,
        network_mode=args.network_mode, refinement=args.refinement,
        refinement_network=args.refinement_network,
        upsample_before_refinement=args.upsample_before_refinement,
        refine_with_confidence=args.refine_with_confidence,
        compute_dtype=args.compute_dtype, cascade=args.cascade)


def make_predictor(mcfg: ModelConfig, args) -> pl.Predictor:
    """`Predictor(mcfg, model_dir, ckpt_step, num_devices)` on `--device`.
    With `--num_devices` > 1 this process joins the process group that
    torchrun describes in the environment (NCCL on cards, gloo with
    `--device cpu`) and serves on its rank's device."""
    device = args.device
    if (args.num_devices or 1) > 1:
        if not dist.is_initialized() and all(
                k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            init_from_env("gloo" if torch.device(device).type == "cpu" else "nccl")
        if dist.is_initialized() and torch.device(device).type == "cuda":
            device = None
    return pl.Predictor(mcfg, args.model_dir, args.ckpt_step, num_devices=args.num_devices,
                        device=device)


def leads() -> bool:
    """Whether this process writes: the only one, or rank 0 of a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def compute_depth_maps(input_dir: str, args, predictor=None):
    """Run inference over one session dir (infer.py:70-105; reference:
    inference.py:83-119). Returns the predictor, for the next session."""
    mcfg = model_config_from_args(args)
    output_dir = args.output_dir or os.path.join(input_dir, "depths_mvsnet")
    if leads():
        mkdir_p(output_dir)
    logger.info("Running inference on %s -> %s", input_dir, output_dir)

    gen = pl.setup_data_iterator(input_dir, mcfg, benchmark=False,
                                 max_clusters_per_session=args.max_clusters_per_session)
    if predictor is None:
        predictor = make_predictor(mcfg, args)

    # the depth at the images' resolution: written with the full images' cam
    upsample = predictor.model.maps_at_image_resolution
    n = len(gen.clusters)
    # predict(fetch=False) returns once the work is queued; the writer
    # thread's .cpu() waits for the card while this loop feeds the next
    # cluster
    with pl.AsyncOutputWriter() as writer:
        for step, batch in enumerate(batch_iterator(gen.iterate_once(), args.batch_size)):
            scaled_images, input_images, scaled_cams, full_cams, indices, _ = batch
            ds, di, dn, de = pl.depth_params_from_cams(scaled_cams)
            t0 = time.time()
            depth, prob, residual = predictor.predict(
                input_images, scaled_cams, ds, di, de, fetch=False)
            logger.info("Depth inference %d/%d dispatched. (%.3f sec/step)",
                        step * args.batch_size, n, time.time() - t0)
            if leads():
                writer.write(output_dir, depth, prob, scaled_images, scaled_cams,
                             full_cams, input_images, indices,
                             residuals=residual, upsample=upsample,
                             sample_scale=args.sample_scale, visualize=args.visualize)
    return predictor


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if os.path.isfile(os.path.join(args.input_dir, "covisibility.json")):
        compute_depth_maps(args.input_dir, args)
    else:
        predictor = None
        for f in sorted(os.listdir(args.input_dir)):
            d = os.path.join(args.input_dir, f)
            if f.startswith(".") or not os.path.isdir(d):
                continue
            logger.info("Computing depth maps on dir %s", d)
            predictor = compute_depth_maps(d, args, predictor)
    return 0


if __name__ == "__main__":
    sys.exit(main())
