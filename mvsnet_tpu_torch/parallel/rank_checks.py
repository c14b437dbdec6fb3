"""Rank programs that run the sharded paths on CPU ranks and hand back what
`tests/test_torch_parallel.py` (and `tests/test_torch_drivers.py`) hold
against the unsharded port and the JAX package. They live in the package because `launch.spawn` imports a rank
program by name in a fresh process, which must import the port alone.

`run(cases)` runs on every rank of a gloo process group; `cases` maps a
case name to its inputs (numpy), and the result maps it to this rank's
outputs (numpy), with the rank's coordinates on each mesh it used.
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from mvsnet_tpu_torch import infer
from mvsnet_tpu_torch import train as driver
from mvsnet_tpu_torch import train_lib
from mvsnet_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from mvsnet_tpu_torch.models import MVSNet
from mvsnet_tpu_torch.models.layers import BatchNormRef
from mvsnet_tpu_torch.ops.cost_volume import sweep_cost_volume_sharded
from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import deconv as deconv_k
from mvsnet_tpu_torch.parallel import halo
from mvsnet_tpu_torch.parallel.mesh import make_mesh
from mvsnet_tpu_torch.parallel.train_step import make_sharded_train_step
from mvsnet_tpu_torch.predict import Predictor


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def sweep(inp):
    """This rank's block of `sweep_cost_volume_sharded` for each V-1."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    _, dp, sp = mesh.coords
    out = {"coords": mesh.coords}
    for vm1, (ref, views, homs) in inp["volumes"].items():
        hl = ref.shape[1] // mesh.axis_size("space")
        rows = slice(sp * hl, (sp + 1) * hl)
        out[vm1] = _np(sweep_cost_volume_sharded(_t(ref)[:, rows], _t(views)[:, :, rows],
                                                 _t(homs), mesh))
    return out


def halo_ops(inp):
    """This rank's slab of the halo conv s1, s2 and transposed conv, and
    the whole ops on the whole volume for reference."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    n, r = mesh.axis_size("depth"), mesh.axis_index("depth")
    x, k, b = _t(inp["x"]), _t(inp["k"]), _t(inp["b"])
    xd, kd = _t(inp["x_deconv"]), _t(inp["k_deconv"])
    Dl, Dld = x.shape[1] // n, xd.shape[1] // n
    mine, mine_d = slice(r * Dl, (r + 1) * Dl), slice(r * Dld, (r + 1) * Dld)
    return {"coords": mesh.coords,
            "s1": _np(halo.halo_conv(x[:, mine], k, b, 1, True, mesh)),
            "s2": _np(halo.halo_conv(x[:, mine], k, b, 2, False, mesh)),
            "deconv": _np(halo.halo_deconv(xd[:, mine_d], kd, b, True, mesh)),
            "want_s1": _np(conv_k.conv(x, k, b, 1, True)),
            "want_s2": _np(conv_k.conv(x, k, b, 2, False)),
            "want_deconv": _np(deconv_k.deconv(xd, kd, b, True))}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def predict(inp):
    """`Predictor.predict` over a mesh (`shape`, or the default mesh of
    the process group when None) on the CPU, with the log it wrote."""
    records = _Records()
    logger = logging.getLogger("mvsnet_tpu_torch")
    logger.addHandler(records)
    try:
        mesh = None if inp["shape"] is None else make_mesh(shape=inp["shape"], backend="gloo")
        p = Predictor(ModelConfig(**inp["cfg"]), state_dict={k: _t(v) for k, v in
                                                             inp["state_dict"].items()},
                      device="cpu", mesh=mesh)
        depth, prob, residual = p.predict(*inp["inputs"])
    finally:
        logger.removeHandler(records)
    return {"mesh": p.mesh.shape, "depth": depth, "prob": prob, "residual": residual,
            "log": records.messages}


def train(inp):
    """One `make_sharded_train_step` step: metrics, gradients, running
    statistics, updated parameters, and whether the batch norms still sum
    over the mesh after it."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    cfg, tcfg = ModelConfig(**inp["cfg"]), TrainConfig(**inp["tcfg"])
    model = MVSNet(cfg)
    model.load_state_dict({k: _t(v) for k, v in inp["state_dict"].items()})
    state = train_lib.create_train_state(model, cfg, tcfg, device=mesh.device)
    state, metrics = make_sharded_train_step(model, cfg, tcfg, mesh)(state, inp["batch"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: _np(p.grad) for n, p in model.named_parameters()},
            "buffers": {n: _np(b) for n, b in model.named_buffers()},
            "params": {n: _np(p) for n, p in model.named_parameters()},
            "norms_synced_after": any(m.batch_sum is not None for m in model.modules()
                                      if isinstance(m, BatchNormRef))}


def driver_batches(inp):
    """The global batches that the driver's train loader gives this rank
    inside the process group, at `inp["workers"]` decode workers: a digest
    of each sample's arrays, batch by batch."""
    mesh = make_mesh(backend="gloo")
    dcfg, tcfg = DataConfig(**inp["data"]), TrainConfig(**inp["tcfg"])
    loader = driver.make_batches(driver.make_loader(dcfg, tcfg, "train"), tcfg.batch_size,
                                 1, inp["workers"], mesh)
    return [[sample_digest(a[k] for a in batch) for k in range(tcfg.batch_size)]
            for batch in loader]


def sample_digest(arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def infer_driver(inp):
    """`python -m mvsnet_tpu_torch.infer`'s `main(inp["argv"])` on this
    rank of the process group: its return code."""
    return infer.main(inp["argv"])


def default_device_error(_inp):
    """What `Predictor(device=None)` raises inside this CPU process group."""
    try:
        Predictor(ModelConfig(network_mode="ultralite", max_d=8, compute_dtype="float32"))
    except RuntimeError as e:
        return str(e)
    return None


CASES = {"sweep": sweep, "halo": halo_ops, "predict": predict, "train": train,
         "driver_batches": driver_batches, "default_device_error": default_device_error,
         "infer_driver": infer_driver}


def run(cases: list) -> list:
    """[(case kind, inputs)] -> [this rank's result], every rank running
    the cases in the same order."""
    return [CASES[kind](inp) for kind, inp in cases]
