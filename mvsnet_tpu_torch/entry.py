"""Entry points of the port (counterparts of the repository's
`__graft_entry__.py`): `entry()`, a forward function and its example
arguments on the flagship 3D-CNN graph (`__graft_entry__.py:35-57`), and
`dryrun_multichip`, the multi-device dry run (`__graft_entry__.py:60-148`).

    python -m mvsnet_tpu_torch.entry 4 gloo       # four CPU ranks
    python -m mvsnet_tpu_torch.entry 2 gloo-cuda  # two ranks on one card

starts n ranks (`parallel.launch.spawn`) on a (data, depth, space) mesh
from `factorize_devices(n)` and runs, on tiny shapes: one sharded train
step, throughput serving at B = n, B = 1 latency serving, and GRU
winner-take-all serving at B = n - 1, which pads the batch to the ranks
(`__graft_entry__.py:123-148`); every result must be finite.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mvsnet_tpu_torch import resolve_device


def tiny_batch(batch: int, view_num: int = 3, height: int = 64, width: int = 64,
               depth_num: int = 8):
    """The dry run's seeded inputs: images, cams, depth map and full-size
    depth map (the scene of `__graft_entry__._tiny_batch`)."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((batch, view_num, height, width, 3)).astype(np.float32)
    K = np.array([[width * 1.2 / 4, 0, width / 8], [0, width * 1.2 / 4, height / 8],
                  [0, 0, 1]])
    cam = np.zeros((2, 4, 4))
    cam[0] = np.eye(4)
    cam[0, 0, 3] = 40.0
    cam[1, :3, :3] = K
    depth_start, depth_interval = 1500.0, 1000.0 / (depth_num - 1)
    cam[1, 3] = [depth_start, depth_interval, depth_num,
                 depth_start + (depth_num - 1) * depth_interval]
    cams = np.broadcast_to(cam, (batch, view_num, 2, 4, 4)).astype(np.float32).copy()
    depth = np.full((batch, height // 4, width // 4, 1), 2000.0, np.float32)
    full_depth = np.full((batch, height, width, 1), 2000.0, np.float32)
    return images, cams, depth, full_depth


def entry(device=None):
    """(forward, example_args): `forward(model, images, cams, depth_start,
    depth_interval) -> (depth, prob)`, the eval forward of MVSNet 3D-CNN,
    and its arguments at 64x64, D=8, 3 views, "lite", bfloat16, seeded
    weights. The tensors live on `device` (None: `cuda:0`, raising without
    CUDA; "cpu": the plain path)."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet, apply_forward_3dcnn

    dev = resolve_device(device)
    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, network_mode="lite",
                      compute_dtype="bfloat16")
    model = MVSNet(cfg, seed=0).to(dev).eval()
    images, cams, _, _ = tiny_batch(1)

    @torch.inference_mode()
    def forward(model, images, cams, depth_start, depth_interval):
        depth, prob, _ = apply_forward_3dcnn(model, images, cams, depth_start, depth_interval)
        return depth, prob

    inputs = (images, cams, cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1])
    return forward, (model,) + tuple(torch.as_tensor(a, device=dev) for a in inputs)


def gru_dryrun(mesh) -> int:
    """The dry run's fourth regime on `mesh`: `make_sharded_gru_forward` of
    an "ultralite" GRU at 64x64, D=8, float32, on B = max(1, n - 1) maps,
    which takes the pad-and-slice path when n > 1. Returns B; raises on a
    non-finite or misshapen result."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.parallel.infer_step import make_sharded_gru_forward

    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, network_mode="ultralite",
                      regularization="GRU", compute_dtype="float32")
    model = MVSNet(cfg, seed=2).to(mesh.device).eval()
    B = max(1, mesh.size - 1)
    images, cams, _, _ = tiny_batch(B)
    args = (images, cams, cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 3])
    with torch.inference_mode():
        depth, prob = make_sharded_gru_forward(model, cfg, mesh)(
            *(torch.as_tensor(a, device=mesh.device) for a in args))
    if depth.shape[0] != B or not (torch.isfinite(depth).all() and torch.isfinite(prob).all()):
        raise FloatingPointError("non-finite or misshapen depth in GRU WTA serving")
    return B


def _dryrun_rank(backend: str) -> dict:
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.parallel.infer_step import make_sharded_forward
    from mvsnet_tpu_torch.parallel.mesh import make_mesh
    from mvsnet_tpu_torch.parallel.train_step import make_sharded_train_step

    mesh = make_mesh(backend=backend)
    n = mesh.size
    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64,
                      network_mode="ultralite", compute_dtype="float32")
    tcfg = TrainConfig(optimizer="adam", base_lr=1e-3, loss_type="original",
                       grad_loss=False)
    model = MVSNet(cfg, seed=0)
    state = train_lib.create_train_state(model, cfg, tcfg, device=mesh.device)
    step, _ = make_sharded_train_step(model, cfg, tcfg, n, mesh)
    _, metrics = step(state, tiny_batch(mesh.shape[0]))
    loss = metrics["loss"].item()
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss} in the multi-device dry run")

    serving = MVSNet(cfg, seed=1).to(mesh.device).eval()
    forward = make_sharded_forward(serving, cfg, mesh)
    out = {"mesh": mesh.shape, "loss": loss}
    for name, B in (("throughput", n), ("latency", 1)):
        images, cams, _, _ = tiny_batch(B)
        args = (images, cams, cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1])
        with torch.inference_mode():
            depth, prob, _ = forward(*(torch.as_tensor(a, device=mesh.device) for a in args))
        if depth.shape[0] != B or not (np.isfinite(depth.cpu().numpy()).all()
                                       and np.isfinite(prob.cpu().numpy()).all()):
            raise FloatingPointError(f"non-finite or misshapen depth in {name} serving")
        out[name] = B
    out["gru_wta"] = gru_dryrun(mesh)
    return out


def dryrun_multichip(n: int, backend: str = "nccl") -> dict:
    """The dry run on n ranks; returns rank 0's summary."""
    from mvsnet_tpu_torch.parallel.launch import spawn

    if backend != "gloo":
        from mvsnet_tpu_torch.ops.kernels import _lib

        _lib.build_all()                      # once, before the ranks start
    summary = spawn(_dryrun_rank, n, backend, backend)[0]
    print(f"dryrun_multichip({n}, {backend}): mesh={summary['mesh']} "
          f"loss={summary['loss']:.4f} serving_batch={summary['throughput']} "
          f"latency_b1=OK gru_wta_batch={summary['gru_wta']} OK")
    return summary


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "nccl")
