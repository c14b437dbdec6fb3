"""Training driver: `python -m mvsnet_tpu_torch.train --train_data_root ... --model_dir ...`
(counterpart of mvsnet_tpu/train.py).

The JAX driver's command line runs unchanged: a prefetching host loader
over mvs-training sessions, the train step (`train_lib.make_train_step`,
or `parallel.train_step.make_sharded_train_step` inside a process group of
more than one rank), snapshots every `--snapshot` samples, validation
rounds when `<train_data_root>/val` exists, an abort with rc 1 on a NaN
loss, a JSONL metrics sink (wandb only when configured), `config.json` in
the model dir, and resuming with `--ckpt_step`.

Inside a process group (`torchrun`, or `--coordinator_address`), every rank
reads the same global batches (one shard, the same seed, one producer
thread so that the order is the generator's) and takes its slice of each
in the sharded step; only rank 0 writes checkpoints, metrics,
renders and `config.json`. `--use_pallas` and `--depth_chunk` are parsed
for the JAX command line and have no effect here. `--regularization GRU`
trains R-MVSNet with the classification loss; `--refinement` trains the
3D-CNN graph with its refinement network (`--refinement_train_mode`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from mvsnet_tpu_torch import checkpoint as ckpt
from mvsnet_tpu_torch import resolve_device, train_lib
from mvsnet_tpu_torch.config import DataConfig, ModelConfig, TrainConfig, save_config
from mvsnet_tpu_torch.data import ClusterGenerator, PrefetchingLoader
from mvsnet_tpu_torch.models import MVSNet
from mvsnet_tpu_torch.parallel.launch import init_from_env
from mvsnet_tpu_torch.parallel.mesh import make_mesh
from mvsnet_tpu_torch.parallel.train_step import (make_sharded_eval_step,
                                                  make_sharded_train_step, shard_state)
from mvsnet_tpu_torch.utils import profiling
from mvsnet_tpu_torch.utils.logging import setup_logger

logger = setup_logger("mvsnet_tpu_torch.train")


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # datasets (reference: train.py:35-50)
    p.add_argument("--train_data_root", required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--model_load_dir", default=None)
    p.add_argument("--ckpt_step", type=int, default=None)
    p.add_argument("--run_name", default=None)
    # input (train.py:53-68)
    p.add_argument("--view_num", type=int, default=3)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--sample_scale", type=float, default=0.25)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--base_image_size", type=int, default=8)
    p.add_argument("--inverse_depth", action="store_true")
    # architecture (train.py:70-90)
    p.add_argument("--regularization", default="3DCNN", choices=["3DCNN", "GRU"])
    p.add_argument("--optimizer", default="rmsprop",
                   choices=["rmsprop", "momentum", "adam"])
    p.add_argument("--refinement", action="store_true")
    p.add_argument("--refinement_train_mode", default="all",
                   choices=["all", "refine_only", "main_only"])
    p.add_argument("--network_mode", default="lite",
                   choices=["normal", "semilite", "lite", "ultralite", "fat", "ultrafat"])
    p.add_argument("--refinement_network", default="unet", choices=["original", "unet"])
    p.add_argument("--upsample_before_refinement", type=str2bool, default=True)
    p.add_argument("--refine_with_confidence", type=str2bool, default=True)
    p.add_argument("--refine_with_stereo", action="store_true")
    # training (train.py:92-135)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--epoch", type=int, default=1)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--base_lr", type=float, default=1e-3)
    p.add_argument("--display", type=int, default=1)
    p.add_argument("--stepvalue", type=int, default=70000)
    p.add_argument("--snapshot", type=int, default=5000)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--val_batch_size", type=int, default=100)
    p.add_argument("--train_steps_per_val", type=int, default=500)
    p.add_argument("--dataset_fraction", type=float, default=1.0)
    p.add_argument("--loss_type", default="power",
                   choices=["original", "power", "gaussian"])
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--eta", type=float, default=0.02)
    p.add_argument("--grad_loss", type=str2bool, default=True)
    p.add_argument("--seed", type=int, default=0)
    # devices
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--device", default="cuda:0",
                   help="the card to train on, or 'cpu' for the plain PyTorch path; "
                        "inside a process group each rank takes its own card")
    p.add_argument("--depth_chunk", type=int, default=16,
                   help="JAX's cost-volume chunking; parsed, no effect in the port")
    p.add_argument("--use_pallas", type=str2bool, default=True,
                   help="JAX's Pallas switch; parsed, no effect in the port (its "
                        "kernels always run on the card)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks; must equal the process group's "
                        "size (default: that size, 1 without a group)")
    p.add_argument("--loader_workers", type=int, default=2)
    # several processes: torchrun sets the environment, or pass these
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0 (torch.distributed's MASTER_ADDR/PORT)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 10-15 here")
    p.add_argument("--image_log_interval", type=int, default=0,
                   help="every N steps render depth/confidence/residual "
                        "maps to <model_dir>/train_vis and wandb "
                        "(0 = off; reference: preprocess.py:198-266)")
    return p


def configs_from_args(args):
    mcfg = ModelConfig(
        view_num=args.view_num, max_d=args.max_d, width=args.width,
        height=args.height, sample_scale=args.sample_scale,
        interval_scale=args.interval_scale, base_image_size=args.base_image_size,
        inverse_depth=args.inverse_depth, regularization=args.regularization,
        network_mode=args.network_mode, refinement=args.refinement,
        refinement_network=args.refinement_network,
        upsample_before_refinement=args.upsample_before_refinement,
        refine_with_confidence=args.refine_with_confidence,
        refine_with_stereo=args.refine_with_stereo,
        compute_dtype=args.compute_dtype)
    tcfg = TrainConfig(
        batch_size=args.batch_size, epoch=args.epoch,
        max_steps_per_epoch=args.max_steps_per_epoch, base_lr=args.base_lr,
        stepvalue=args.stepvalue, gamma=args.gamma, snapshot=args.snapshot,
        optimizer=args.optimizer, loss_type=args.loss_type, alpha=args.alpha,
        beta=args.beta, eta=args.eta, grad_loss=args.grad_loss,
        refinement_train_mode=args.refinement_train_mode,
        val_batch_size=args.val_batch_size,
        train_steps_per_val=args.train_steps_per_val, seed=args.seed,
        num_devices=args.num_devices)
    dcfg = DataConfig(
        data_dir=args.train_data_root, view_num=args.view_num,
        image_width=args.width, image_height=args.height, depth_num=args.max_d,
        interval_scale=args.interval_scale, base_image_size=args.base_image_size,
        flip_cams=(args.regularization == "GRU"),
        sessions_frac=args.dataset_fraction)
    return mcfg, tcfg, dcfg


class MetricsSink:
    """JSONL metrics log, plus optional wandb mirroring (reference logged to
    wandb at train.py:506-515). wandb engages only when the package is
    installed AND WANDB_API_KEY/WANDB_MODE is configured, never by default."""

    def __init__(self, path, run_name=None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._wandb = None
        if os.environ.get("WANDB_API_KEY") or os.environ.get("WANDB_MODE"):
            try:
                import wandb  # noqa: PLC0415
                wandb.init(project=os.environ.get("WANDB_PROJECT", "mvsnet_tpu"),
                           name=run_name)
                self._wandb = wandb
            except Exception as e:  # wandb missing/unconfigured: JSONL only
                logger.debug("wandb disabled: %s", e)

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "time"},
                            step=step)

    def log_images(self, step: int, images: dict):
        """Mirror rendered arrays to wandb (reference logged depth/
        confidence/residual renders, preprocess.py:198-266)."""
        if self._wandb is not None:
            self._wandb.log({k: self._wandb.Image(np.asarray(v))
                             for k, v in images.items()}, step=step)


def make_vis_writer(model, model_dir, sink):
    """Training-time image artifacts: the current batch's depth /
    confidence / |residual| maps from the eval forward, written as PNGs to
    <model_dir>/train_vis/step_<N>/ through `io/images` and mirrored to
    wandb (reference: preprocess.py:198-266, train.py:506-515)."""
    from mvsnet_tpu_torch.io import filesystem as fsio
    from mvsnet_tpu_torch.io import images as imio

    def write(state, batch, total_step):
        images, cams, gt_depth = train_lib.to_device(batch, state.device)[:3]
        ds, di, _ = train_lib.batch_depth_params(cams)
        model.eval()
        with torch.no_grad():
            if model.cfg.regularization == "GRU":
                depth, prob = model.forward_gru_wta(images[:1], cams[:1], ds[:1], di[:1])
            else:
                # the main map, as JAX's driver renders it (train.py:187-188)
                depth, prob = model.forward_3dcnn(images[:1], cams[:1], ds[:1], di[:1])
        depth = depth[0, ..., 0].float().cpu().numpy()
        prob = prob[0, ..., 0].float().cpu().numpy()
        gt = gt_depth[0, ..., 0].cpu().numpy()
        residual = np.abs(depth - gt) * (gt > 0)
        outdir = fsio.join(model_dir, "train_vis", f"step_{total_step}")
        fsio.makedirs(outdir)
        imio.write_inverse_depth_png(fsio.join(outdir, "depth.png"), depth)
        imio.write_confidence_png(fsio.join(outdir, "confidence.png"), prob)
        imio.write_depth_png(fsio.join(outdir, "residual.png"), residual)
        sink.log_images(total_step, {"depth": depth, "confidence": prob,
                                     "residual": residual})

    return write


def make_loader(dcfg: DataConfig, tcfg: TrainConfig, mode: str):
    """A factory of `ClusterGenerator`s over `mode`'s split. Every rank of a
    process group reads the whole data (shard 0 of 1, one seed): the
    sharded step slices the global batch."""
    def factory():
        return ClusterGenerator(
            dcfg.data_dir, dcfg.view_num, dcfg.image_width, dcfg.image_height,
            dcfg.depth_num, dcfg.interval_scale, dcfg.base_image_size,
            mode=mode, flip_cams=dcfg.flip_cams,
            sessions_frac=dcfg.sessions_frac,
            max_clusters_per_session=dcfg.max_clusters_per_session,
            seed=tcfg.seed)
    return factory


def make_batches(factory, batch_size: int, epochs, workers: int, mesh) -> PrefetchingLoader:
    """Batches of `factory`'s samples. With more than one worker the loader
    yields samples as their clusters finish decoding, an order that differs
    from rank to rank; inside a process group every rank must see the same
    global batches, so there it reads with one producer, in the generator's
    own order."""
    return PrefetchingLoader(factory, batch_size=batch_size, epochs=epochs,
                             workers=1 if mesh is not None else workers)


def maybe_init_distributed(args) -> None:
    """Join a process group: the one a caller already made, the one
    `torchrun` describes in the environment, or the one
    `--coordinator_address host:port`, `--num_processes` and
    `--process_id` describe. NCCL on cards, gloo with `--device cpu`.
    No-op for a single process."""
    if dist.is_available() and dist.is_initialized():
        return
    if args.coordinator_address:
        host, port = args.coordinator_address.rsplit(":", 1)
        cards = max(1, torch.cuda.device_count())
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(args.process_id),
                          WORLD_SIZE=str(args.num_processes))
        os.environ.setdefault("LOCAL_RANK", str(args.process_id % cards))
    elif not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return
    init_from_env("gloo" if torch.device(args.device).type == "cpu" else "nccl")
    logger.info("joined distributed run: process %d/%d", dist.get_rank(),
                dist.get_world_size())


def _mesh(args):
    """The training mesh over the process group's ranks, or None for one."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    if torch.device(args.device).type == "cpu":
        backend = "gloo"
    else:
        backend = "nccl" if dist.get_backend() == "nccl" else "gloo-cuda"
    return make_mesh(backend=backend)


def train(args) -> int:
    maybe_init_distributed(args)
    mcfg, tcfg, dcfg = configs_from_args(args)
    mesh = _mesh(args)
    world = 1 if mesh is None else mesh.size
    if tcfg.num_devices not in (None, world):
        raise ValueError(f"--num_devices {tcfg.num_devices} with {world} rank(s): start one "
                         "process per device (torchrun --nproc_per_node=N)")
    device = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    metrics_sink = None
    if lead:
        metrics_sink = MetricsSink(os.path.join(args.model_dir, "metrics.jsonl"),
                                   run_name=args.run_name)
        os.makedirs(args.model_dir, exist_ok=True)
        save_config(os.path.join(args.model_dir, "config.json"),
                    model=mcfg, train=tcfg, data=dcfg)

    train_gen = make_loader(dcfg, tcfg, "train")()
    samples_per_epoch = len(train_gen)
    train_loader = make_batches(lambda: train_gen, tcfg.batch_size, tcfg.epoch,
                                args.loader_workers, mesh)

    model = MVSNet(mcfg, seed=tcfg.seed)
    state = train_lib.create_train_state(model, mcfg, tcfg, device=device)
    total_step = 0
    if args.ckpt_step is not None:
        load_dir = args.model_load_dir or args.model_dir
        state = ckpt.restore_checkpoint(load_dir, mcfg.regularization,
                                        mcfg.network_mode, state, args.ckpt_step)
        total_step = args.ckpt_step
        logger.info("Restored checkpoint step %d from %s", total_step, load_dir)
    if mesh is not None:
        state = shard_state(state, mesh)
        step_fn, _ = make_sharded_train_step(model, mcfg, tcfg, world, mesh)
        eval_step = make_sharded_eval_step(model, mcfg, tcfg, mesh)
    else:
        step_fn = train_lib.make_train_step(model, mcfg, tcfg)
        eval_step = train_lib.make_eval_step(model, mcfg, tcfg)

    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Training MVSNet(%s/%s) with %d params on %d rank(s), %s; "
                "%d samples/epoch", mcfg.regularization, mcfg.network_mode,
                n_params, world, device, samples_per_epoch)

    # validation (reference: train.py:373-409), only when a val split exists
    has_val = os.path.isdir(os.path.join(dcfg.data_dir, "val"))

    def run_validation(state, total_step):
        val_loader = make_batches(make_loader(dcfg, tcfg, "val"), tcfg.batch_size, 1,
                                  args.loader_workers, mesh)
        vals = []
        for i, vbatch in enumerate(val_loader):
            if i >= int(tcfg.val_batch_size):
                break
            vals.append({k: float(v) for k, v in eval_step(state, vbatch).items()})
        if vals and lead:
            avg = {("val_" + k): float(np.mean([m[k] for m in vals])) for k in vals[0]}
            metrics_sink.log(total_step, **avg)
            logger.info("VAL step %d: %s", total_step,
                        {k: round(v, 4) for k, v in avg.items()})

    vis_writer = (make_vis_writer(model, args.model_dir, metrics_sink)
                  if args.image_log_interval and lead else None)
    # the reference advances its step counter by the samples consumed
    # (train.py:518-519); every rank reads the global batch
    samples_per_step = tcfg.batch_size
    profiler = None
    window = []
    t_step = time.time()
    try:
        for step, batch in enumerate(train_loader):
            if (tcfg.max_steps_per_epoch is not None
                    and step >= tcfg.max_steps_per_epoch * tcfg.epoch):
                break
            if args.profile_dir and step == 10:
                profiler = profiling.start(device)
            if profiler is not None and step == 15:
                _stop_profiler(profiler, args.profile_dir, 0 if mesh is None else mesh.rank)
                profiler = None
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            duration = time.time() - t_step
            t_step = time.time()
            if np.isnan(loss):
                logger.error("NaN loss at step %d, aborting (reference behavior)", total_step)
                return 1
            window.append({k: float(v) for k, v in metrics.items()})
            if step % args.display == 0:
                logger.info("step %d total %d loss=%.4f <1px=%.4f <3px=%.4f (%.3fs)",
                            step, total_step, loss, float(metrics["less_one"]),
                            float(metrics["less_three"]), duration)
            if step % 50 == 0 and window:
                avg = {k: float(np.mean([m[k] for m in window])) for k in window[0]}
                if lead:
                    metrics_sink.log(total_step, time_per_step=duration, **avg)
                window = []
            total_step += samples_per_step
            if lead and total_step % tcfg.snapshot < samples_per_step:
                ckpt.save_checkpoint(args.model_dir, mcfg.regularization,
                                     mcfg.network_mode, total_step, state)
            if has_val and step > 0 and step % int(tcfg.train_steps_per_val) == 0:
                run_validation(state, total_step)
            if vis_writer is not None and step % args.image_log_interval == 0:
                try:
                    vis_writer(state, batch, total_step)
                except Exception as e:  # visualization must never kill training
                    logger.warning("image logging failed at step %d: %s", total_step, e)
    finally:
        if profiler is not None:
            _stop_profiler(profiler, args.profile_dir, 0 if mesh is None else mesh.rank)

    if lead:
        ckpt.save_checkpoint(args.model_dir, mcfg.regularization, mcfg.network_mode,
                             total_step, state)
    logger.info("Training done at step %d", total_step)
    return 0


def _stop_profiler(profiler, profile_dir, rank: int):
    path = profiling.stop(profiler, profile_dir, f"trace_rank{rank}.json")
    logger.info("profiler trace written to %s", path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return train(args)


if __name__ == "__main__":
    sys.exit(main())
