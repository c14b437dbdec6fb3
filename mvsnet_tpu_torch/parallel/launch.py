"""Starting the ranks of a mesh (no JAX counterpart: a JAX program sees all
local devices from one process).

`spawn(fn, nprocs, backend, *args)` starts `nprocs` fresh processes
(`torch.multiprocessing`, the spawn start method), joins them into one
process group through a `file://` rendezvous in a temporary directory, runs
`fn(*args)` on each and returns the results in rank order. `fn` must be
importable by name (a module-level function of an installed module), and
its result picklable: return numpy arrays or Python values, not tensors.

Under `torchrun --nproc_per_node=N script.py`, the script calls
`init_from_env(backend)` instead, which reads the RANK, WORLD_SIZE,
LOCAL_RANK and MASTER_ADDR/PORT that torchrun sets.

Backends as in `parallel/mesh.py`: "nccl" (one rank per card), "gloo"
(CPU), "gloo-cuda" (gloo between ranks on cards, so several ranks can
share one card). Build the CUDA kernels once before starting ranks on
cards (`ops.kernels._lib.build_all()`), or every rank runs nvcc.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mvsnet_tpu_torch.parallel.mesh import BACKENDS


def _group_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return "nccl" if backend == "nccl" else "gloo"


def init_from_env(backend: str) -> None:
    """Join the process group that torchrun describes in the environment."""
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(_group_backend(backend), init_method="env://")


def _rank_main(fn, rank, world, backend, init_method, results, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if backend == "gloo":
        # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    elif backend == "nccl":
        torch.cuda.set_device(rank)
    try:
        dist.init_process_group(_group_backend(backend), init_method=init_method,
                                rank=rank, world_size=world)
        out = fn(*args)
    except BaseException:                      # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


TIMEOUT_S = 900.0


def spawn(fn, nprocs: int, backend: str, *args) -> list:
    """Run `fn(*args)` as ranks 0..nprocs-1 of one process group; returns
    their results in rank order. Raises with the rank's traceback if one
    fails or all have not finished within TIMEOUT_S, and stops the others
    (they may wait in a collective)."""
    _group_backend(backend)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mvsnet_mesh_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, backend, init_method, results, args))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        done, failure = {}, None
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while len(done) < nprocs and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} before returning")
                    elif time.monotonic() > deadline:
                        failure = f"ranks {sorted(set(range(nprocs)) - set(done))} " \
                                  f"did not finish within {TIMEOUT_S:.0f} s"
                    continue
                if ok:
                    done[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                p.join(timeout=None if failure is None else 5.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
        if failure is not None:
            raise RuntimeError(failure)
        return [done[r] for r in range(nprocs)]
