"""Rank programs that run the sharded paths on CPU ranks and hand back what
`tests/test_torch_parallel.py` (and `tests/test_torch_drivers.py`) hold
against the unsharded port and the JAX package. They live in the package because `launch.spawn` imports a rank
program by name in a fresh process, which must import the port alone.

`run(cases)` runs on every rank of a gloo process group; `cases` maps a
case name to its inputs (numpy), and the result maps it to this rank's
outputs (numpy), with the rank's coordinates on each mesh it used.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mvsnet_tpu_torch import infer
from mvsnet_tpu_torch import train as driver
from mvsnet_tpu_torch import train_lib
from mvsnet_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from mvsnet_tpu_torch.models import MVSNet
from mvsnet_tpu_torch.models.feature_net import TOWER_LAYERS
from mvsnet_tpu_torch.models.layers import BatchNormRef
from mvsnet_tpu_torch.models.mvsnet import GRUSweep
from mvsnet_tpu_torch.ops.cost_volume import CostVolumeFn, sweep_cost_volume_sharded
from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map_sharded
from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import deconv as deconv_k
from mvsnet_tpu_torch.parallel import halo
from mvsnet_tpu_torch.parallel.infer_step import latency_forward
from mvsnet_tpu_torch.parallel.mesh import AxisSplit, make_mesh
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
    """This rank's depth slab of the halo conv s1, s2 and transposed conv
    (rows whole), and the whole ops on the whole volume for reference."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    n, r = mesh.axis_size("depth"), mesh.axis_index("depth")
    x, k, b = _t(inp["x"]), _t(inp["k"]), _t(inp["b"])
    xd, kd = _t(inp["x_deconv"]), _t(inp["k_deconv"])
    Dl, Dld = x.shape[1] // n, xd.shape[1] // n
    mine, mine_d = slice(r * Dl, (r + 1) * Dl), slice(r * Dld, (r + 1) * Dld)
    slabs = (AxisSplit("depth", x.shape[1], n, r), None, None)
    return {"coords": mesh.coords,
            "s1": _np(halo.halo_conv(x[:, mine], k, b, 1, True, mesh=mesh, splits=slabs,
                                     level=0)),
            "s2": _np(halo.halo_conv(x[:, mine], k, b, 2, False, mesh=mesh, splits=slabs,
                                     level=0)),
            "deconv": _np(halo.halo_deconv(xd[:, mine_d], kd, b, True, mesh=mesh,
                                           splits=slabs, level=1)),
            "want_s1": _np(conv_k.conv(x, k, b, 1, True)),
            "want_s2": _np(conv_k.conv(x, k, b, 2, False)),
            "want_deconv": _np(deconv_k.deconv(xd, kd, b, True))}


def block_of(t, splits, level, index=None):
    """The block of the whole tensor t (B, *spatial, C) that `splits` (one
    AxisSplit or None per spatial axis) give a rank at `level`."""
    for dim, split in enumerate(splits, start=1):
        if split is not None:
            a, b = split.bounds(level, index[dim - 1] if index else None)
            t = t.narrow(dim, a, b - a)
    return t


def halo_blocks(inp):
    """This rank's block of each halo op of `inp["ops"]` (kind, level, x,
    kernel, cotangent) over a mesh (1, depth, space), the volume's axes at
    level 0 `inp["sizes"]` (3D: planes and rows; 2D: rows), with the
    gradients of sum(out * cotangent) on the plain path: the block's dx
    and this rank's share of dk."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    sizes = inp["sizes"]
    if len(sizes) == 2:
        splits = (AxisSplit("depth", sizes[0], mesh.axis_size("depth"),
                            mesh.axis_index("depth")),
                  AxisSplit("space", sizes[1], mesh.axis_size("space"),
                            mesh.axis_index("space")), None)
    else:
        splits = (AxisSplit("space", sizes[0], mesh.axis_size("space"),
                            mesh.axis_index("space")), None)
    out = {"coords": mesh.coords}
    for name, (kind, level, x, k, cot) in inp["ops"].items():
        xb = block_of(_t(x), splits, level).clone().requires_grad_(True)
        kt = _t(k).requires_grad_(True)
        if kind == "up":
            y = halo.halo_deconv(xb, kt, None, False, mesh=mesh, splits=splits, level=level)
            out_level = level - 1
        else:
            y = halo.halo_conv(xb, kt, None, 1 if kind == "s1" else 2, False, mesh=mesh,
                               splits=splits, level=level)
            out_level = level + (kind != "s1")
        (y * block_of(_t(cot), splits, out_level)).sum().backward()
        with torch.no_grad():
            bias = torch.linspace(-1, 1, k.shape[-1])
            if kind == "up":
                y_eval = halo.halo_deconv(xb, kt, bias, True, mesh=mesh, splits=splits,
                                          level=level)
            else:
                y_eval = halo.halo_conv(xb, kt, bias, 1 if kind == "s1" else 2, True,
                                        mesh=mesh, splits=splits, level=level)
        out[name] = {"y": _np(y), "dx": _np(xb.grad), "dk": _np(kt.grad), "y_eval": _np(y_eval),
                     "bounds": [s.bounds(out_level) if s else None for s in splits],
                     "in_bounds": [s.bounds(level) if s else None for s in splits]}
    return out


class ShapeAudit(TorchDispatchMode):
    """Records the shape of every tensor an op makes while it is active."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


@contextlib.contextmanager
def tower_rows(model):
    """{layer: (input rows, output rows)} of each feature-tower layer's last
    call while the block is active (the rows a rank's tower works on)."""
    rows, hooks = {}, []
    for name, _, _ in TOWER_LAYERS:
        def hook(module, args, out, name=name):
            rows[name] = (args[0].shape[1], out.shape[1])
        hooks.append(model.feature_net._modules[name].register_forward_hook(hook))
    try:
        yield rows
    finally:
        for h in hooks:
            h.remove()


def whole_tower_shapes(shapes, N, H, W):
    """The shapes among `shapes` that hold a whole (N, H / 2^l, W / 2^l, C)
    map of the feature tower at some level l of 0-4, the images (level 0,
    C = 3) exempt."""
    return [tuple(s) for s in shapes if len(s) == 4 and any(
        tuple(s[:3]) == (N, -(-H // 2 ** lv), -(-W // 2 ** lv)) and (lv or s[3] != 3)
        for lv in range(5))]


def whole_volume_shapes(shapes, D, h, w):
    """The shapes among `shapes` that hold a whole (D, h, w) volume in any
    layout: D, h and w (or D, w, h; h, w, D) in that order, not
    necessarily adjacent."""
    def holds(shape, dims):
        it = iter(shape)
        return all(any(d == s for s in it) for d in dims)
    return [tuple(s) for s in shapes
            if any(holds(s, p) for p in ((D, h, w), (D, w, h), (h, w, D)))]


def audit(inp):
    """The shapes of every tensor one latency request makes on this rank
    (`latency_forward`, from the images to the gathered maps), the
    request's depth map and its tower's rows."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    model = MVSNet(ModelConfig(**inp["cfg"]), seed=1)
    args = tuple(_t(a) for a in inp["inputs"][:4])
    with torch.no_grad(), ShapeAudit() as seen, tower_rows(model) as rows:
        depth, _, _ = latency_forward(model, mesh, *args)
    return {"coords": mesh.coords, "shapes": sorted(seen.shapes), "depth": _np(depth),
            "tower_rows": rows}


def tail(inp):
    """This rank's collective soft-argmin tail over its depth slab of
    `inp["reg"]` for each (num_buckets, inverse_depth) of `inp["tails"]`."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    reg = _t(inp["reg"])
    n, r = mesh.axis_size("depth"), mesh.axis_index("depth")
    Dl = reg.shape[1] // n
    ds, di, de = (_t(a) for a in inp["range"])
    out = {}
    for buckets, inverse in inp["tails"]:
        out[(buckets, inverse)] = tuple(_np(t) for t in soft_argmin_prob_map_sharded(
            reg[:, r * Dl:(r + 1) * Dl], r * Dl, ds, di, reg.shape[1], inverse, de, buckets,
            reduce_sum=lambda t: mesh.all_reduce_replicated(t, "depth"),
            reduce_max=lambda t: mesh.all_reduce(t, "depth", op="max")))
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def predict(inp):
    """`Predictor.predict` over a mesh (`shape`, or the default mesh of
    the process group when None) on the CPU, with the log it wrote and its
    tower's rows."""
    records = _Records()
    logger = logging.getLogger("mvsnet_tpu_torch")
    logger.addHandler(records)
    try:
        mesh = None if inp["shape"] is None else make_mesh(shape=inp["shape"], backend="gloo")
        p = Predictor(ModelConfig(**inp["cfg"]), state_dict={k: _t(v) for k, v in
                                                             inp["state_dict"].items()},
                      device="cpu", mesh=mesh)
        with tower_rows(p.model) as rows:
            depth, prob, residual = p.predict(*inp["inputs"])
    finally:
        logger.removeHandler(records)
    return {"mesh": p.mesh.shape, "depth": depth, "prob": prob, "residual": residual,
            "log": records.messages, "tower_rows": rows}


def train(inp):
    """One `make_sharded_train_step` step: metrics, gradients, running
    statistics, updated parameters, the shapes of the cost volumes it built,
    the GRU sweeps it ran (`GRUSweep`'s method names), the tower's rows, the
    log, and whether the batch norms still sum over the mesh after it."""
    mesh = make_mesh(shape=inp["shape"], backend="gloo")
    cfg, tcfg = ModelConfig(**inp["cfg"]), TrainConfig(**inp["tcfg"])
    model = MVSNet(cfg)
    model.load_state_dict({k: _t(v) for k, v in inp["state_dict"].items()})
    state = train_lib.create_train_state(model, cfg, tcfg, device=mesh.device)
    costs, forward = [], CostVolumeFn.forward
    sweeps, sweep_fns = [], {k: getattr(GRUSweep, k) for k in ("remat", "eager", "graphed")}

    def recording(ctx, *args):
        out = forward(ctx, *args)
        costs.append(tuple(out.shape))
        return out

    def sweep_recording(kind):
        def run(self, *args, **kwargs):
            sweeps.append(kind)
            return sweep_fns[kind](self, *args, **kwargs)
        return run
    CostVolumeFn.forward = staticmethod(recording)
    for kind in sweep_fns:
        setattr(GRUSweep, kind, sweep_recording(kind))
    records = _Records()
    logging.getLogger("mvsnet_tpu_torch").addHandler(records)
    try:
        with tower_rows(model) as rows:
            state, metrics = make_sharded_train_step(model, cfg, tcfg, mesh)(state,
                                                                            inp["batch"])
    finally:
        CostVolumeFn.forward = staticmethod(forward)
        for kind, fn in sweep_fns.items():
            setattr(GRUSweep, kind, fn)
        logging.getLogger("mvsnet_tpu_torch").removeHandler(records)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "costs": costs,
            "sweeps": sweeps, "tower_rows": rows, "log": records.messages,
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


CASES = {"sweep": sweep, "halo": halo_ops, "halo_blocks": halo_blocks, "audit": audit,
         "tail": tail, "predict": predict, "train": train,
         "driver_batches": driver_batches, "default_device_error": default_device_error,
         "infer_driver": infer_driver}


def run(cases: list) -> list:
    """[(case kind, inputs)] -> [this rank's result], every rank running
    the cases in the same order."""
    return [CASES[kind](inp) for kind, inp in cases]
