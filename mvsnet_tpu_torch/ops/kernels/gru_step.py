"""The ConvGRU's depth step between its convs: a gates and an output kernel
a cell and a tail (`csrc/gru_step.cu`), and their plain twin.

Replaces no TPU kernel: the JAX package's scan leaves these passes to XLA.
On the card the plain cell (`models/gru.ConvGRUCell`) makes some 70
launches a depth step besides its 7 convs; these kernels make 7, on the
buffers of `models/mvsnet._FusedStep`. Each cell keeps one channels-last
bf16 input `inp` (B, h, w, in + F) = [x | slot] that both its convs read:
- `gates(g, h, inp, update, ...)` after the gates conv (g: (B, h, w, 2F)
  bf16): the reset and update halves' layer norms (`layer_norm_plain`),
  their sigmoids; (r * h).bf16 into the slot, u into `update`;
- `output(y, update, h, inp, nxt, ...)` after the output conv (y: (B, h, w,
  F) bf16): y's layer norm, its tanh, h' = u * h + (1 - u) * y in float32
  into h in place, h'.bf16 into the slot and into the first F channels of
  `nxt` (the next cell's input, or prob_conv's);
- `tail(reg, out, carry, depth)` after prob_conv: the reg in float32 into
  `out`, and with a carry the winner-take-all update in place.
Each rounds where `ConvGRUCell.forward` rounds. The layer norm's statistics
are two-pass, each image's float64 sums cast to float32 (`moments_plain`):
on the card in an order fixed by the image's size, so an image's numbers do
not depend on the batch it is served in.

Each wrapper runs its plain twin (`*_plain`, the same arithmetic in plain
PyTorch) on CPU tensors and its kernel on CUDA tensors, never one for the
other. `launches.gru_step` (`utils/profiling.py`) counts the kernels'
launches, 7 a depth step.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mvsnet_tpu_torch.ops.depth import winner_take_all_update
from mvsnet_tpu_torch.ops.kernels import _lib
from mvsnet_tpu_torch.utils import profiling

EPS = 1e-12                   # GroupNormFlexible's eps at G = 1
FILTERS = (1, 2, 4, 8, 16)    # csrc/gru_step.cu by_filters
MAX_BATCH = 128               # csrc/gru_step.cu kMaxPairs / 2
_CHUNK = 1024                 # csrc/gru_step.cu kChunk: pixels a chunk
_THREADS = 256                # csrc/gru_step.cu kThreads: a block

_I, _L, _P, _D, _F = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_double, ctypes.c_float
_ARGTYPES = {
    "gates_launch": [_I, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _D, _F, _P, _P, _I, _L, _I,
                     _I, _P],
    "output_launch": [_I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _D, _F, _P, _P, _I, _L, _I,
                      _I, _P],
    "tail_launch": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _P],
    "capacity": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}
_fns: dict = {}
# (device index, F) -> the blocks of the gates and the output kernel that
# the device holds at once
_capacity: dict = {}


def _fn(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        fn = _fns[entry] = _lib.launcher("gru_step", _ARGTYPES[entry], entry=entry)
    return fn


# ---- the plain twin

def moments_plain(x):
    """x (B, ..., C) -> mean, var (B,) float32 over every axis but the
    first, and x - mean in float32: two passes, each a float64 sum of the
    float32 values times the host's float64 reciprocal of the count, cast
    to float32; the second sums (x - mean)^2 taken in float32."""
    xf = x.to(torch.float32)
    axes = tuple(range(1, x.ndim))
    inv = 1.0 / math.prod(x.shape[1:])
    bshape = (-1,) + (1,) * (x.ndim - 1)
    mean = (xf.sum(dim=axes, dtype=torch.float64) * inv).to(torch.float32)
    centered = xf - mean.reshape(bshape)
    var = ((centered * centered).sum(dim=axes, dtype=torch.float64) * inv).to(torch.float32)
    return mean, var, centered


def layer_norm_plain(x, scale, bias):
    """GroupNormFlexible at G = 1 with `moments_plain`'s statistics:
    (x - mean) / sqrt(var + eps) * scale + bias in float32, cast to x's
    dtype."""
    _, var, centered = moments_plain(x)
    den = torch.sqrt(var + EPS).reshape((-1,) + (1,) * (x.ndim - 1))
    return (centered / den * scale + bias).to(x.dtype)


def gates_plain(g, h, inp, update, r_scale, r_bias, u_scale, u_bias):
    """The gates kernel's arithmetic: see the module docstring."""
    F = h.shape[-1]
    reset = torch.sigmoid(layer_norm_plain(g[..., :F], r_scale, r_bias))
    inp[..., -F:] = (reset * h).to(inp.dtype)
    update.copy_(torch.sigmoid(layer_norm_plain(g[..., F:], u_scale, u_bias)))


def output_plain(y, update, h, inp, nxt, scale, bias):
    """The output kernel's arithmetic: see the module docstring."""
    F = h.shape[-1]
    y = torch.tanh(layer_norm_plain(y, scale, bias))
    h.copy_(update * h + (1 - update) * y)
    inp[..., -F:] = h
    nxt[..., :F] = h


def tail_plain(reg, out, carry=None, depth=None):
    """The tail kernel's arithmetic: see the module docstring."""
    out.copy_(reg[..., 0])
    if carry is not None:
        new = winner_take_all_update(carry, torch.exp(out)[..., None], depth)
        for dst, src in zip(carry, new):
            dst.copy_(src)


# ---- the kernels

def workspace(batch: int, pixels: int, device):
    """The gates and output kernels' scratch for maps of `batch` images of
    `pixels` pixels: two areas of float64 partial sums and the grid
    barrier's words (zero, and left at zero by every launch). One
    workspace serves launches that follow one another on a stream."""
    chunks = -(-pixels // _CHUNK)
    return (torch.empty(2 * 2 * batch * chunks, dtype=torch.float64, device=device),
            torch.zeros(64, dtype=torch.int32, device=device))


def _check(name, t, shape, dtype, device):
    if t.device != device or tuple(t.shape) != tuple(shape) or t.dtype != dtype or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _vec(t, F: int, offset: int) -> int:
    """Channels a store moves at once into F channels from `offset` of each
    pixel of bf16 map t: the most of 8, 4, 2, 1 that the alignment takes."""
    C = t.shape[-1]
    return next(v for v in (8, 4, 2, 1) if F % v == 0 and C % v == 0 and offset % v == 0
                and (t.data_ptr() + 2 * offset) % (2 * v) == 0)


def _geometry(x, h, F, work):
    """(B, P, chunks, grid, workspace) for a norm over x, whose state h is
    (B, ..., F): a grid of up to a thread a pixel, at most one wave of the
    blocks the card holds at once; raises on what the kernels do not take."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the GRU step kernels take CUDA tensors, got one on {dev}")
    B = h.shape[0]
    P = h.numel() // (B * F) if B * F else 0
    if F not in FILTERS or not 1 <= B <= MAX_BATCH or P < 1:
        raise ValueError(f"the GRU step kernels take F in {FILTERS}, 1 to {MAX_BATCH} images and "
                         f"a non-empty map, got F={F}, B={B}, shape {tuple(h.shape)}")
    chunks = -(-P // _CHUNK)
    key = (dev.index, F)
    cap = _capacity.get(key)
    if cap is None:
        a, b = _I(), _I()
        with torch.cuda.device(dev):   # the query reads the current device
            _lib.check("gru_step", _fn("capacity")(F, ctypes.byref(a), ctypes.byref(b)))
        cap = _capacity[key] = min(a.value, b.value)
    if work is None:
        work = workspace(B, P, dev)
    part, bar = work
    if part.numel() < 4 * B * chunks or part.dtype != torch.float64 or bar.numel() != 64:
        raise ValueError(f"the workspace is for fewer than {B} images of {P} pixels")
    return B, P, chunks, min(-(-B * P // _THREADS), cap), work


def gates(g, h, inp, update, r_scale, r_bias, u_scale, u_bias, work=None):
    """After a cell's gates conv: see the module docstring. g (B, h, w, 2F)
    bf16, h (B, h, w, F) float32, inp (B, h, w, in + F) and update (B, h, w,
    F) bf16, written in place; the norms' (F) float32 parameters; `work` a
    `workspace` (else one is made). One launch on a card."""
    if g.device.type == "cpu":
        return gates_plain(g, h, inp, update, r_scale, r_bias, u_scale, u_bias)
    F = h.shape[-1]
    B, P, chunks, grid, (part, bar) = _geometry(g, h, F, work)
    dev, lead = g.device, tuple(h.shape[:-1])
    _check("g", g, lead + (2 * F,), torch.bfloat16, dev)
    _check("h", h, lead + (F,), torch.float32, dev)
    _check("inp", inp, lead + (inp.shape[-1],), torch.bfloat16, dev)
    _check("update", update, lead + (F,), torch.bfloat16, dev)
    params = [p.contiguous() for p in (r_scale, r_bias, u_scale, u_bias)]
    for p in params:
        _check("a norm parameter", p, (F,), torch.float32, dev)
    cin = inp.shape[-1]
    err = _fn("gates_launch")(F, g.data_ptr(), h.data_ptr(), inp.data_ptr(), cin,
                              _vec(inp, F, cin - F), update.data_ptr(), _vec(update, F, 0),
                              *(p.data_ptr() for p in params), 1.0 / (P * F), EPS,
                              part.data_ptr(), bar.data_ptr(), B, P, chunks, grid,
                              _lib.stream_of(g))
    _lib.check("gru_step", err)
    profiling.count("launches.gru_step")


def output(y, update, h, inp, nxt, scale, bias, work=None):
    """After a cell's output conv: see the module docstring. y, update (B, h,
    w, F) bf16; h (B, h, w, F) float32, updated in place; inp (B, h, w, in +
    F) and nxt (B, h, w, C >= F) bf16, written in place; the norm's (F)
    float32 parameters; `work` as for `gates`. One launch on a card."""
    if y.device.type == "cpu":
        return output_plain(y, update, h, inp, nxt, scale, bias)
    F = h.shape[-1]
    B, P, chunks, grid, (part, bar) = _geometry(y, h, F, work)
    dev, lead = y.device, tuple(h.shape[:-1])
    _check("y", y, lead + (F,), torch.bfloat16, dev)
    _check("update", update, lead + (F,), torch.bfloat16, dev)
    _check("h", h, lead + (F,), torch.float32, dev)
    _check("inp", inp, lead + (inp.shape[-1],), torch.bfloat16, dev)
    _check("nxt", nxt, lead + (nxt.shape[-1],), torch.bfloat16, dev)
    params = [p.contiguous() for p in (scale, bias)]
    for p in params:
        _check("a norm parameter", p, (F,), torch.float32, dev)
    cin, cn = inp.shape[-1], nxt.shape[-1]
    err = _fn("output_launch")(F, y.data_ptr(), update.data_ptr(), h.data_ptr(), inp.data_ptr(),
                               cin, _vec(inp, F, cin - F), nxt.data_ptr(), cn, _vec(nxt, F, 0),
                               *(p.data_ptr() for p in params), 1.0 / (P * F), EPS,
                               part.data_ptr(), bar.data_ptr(), B, P, chunks, grid,
                               _lib.stream_of(y))
    _lib.check("gru_step", err)
    profiling.count("launches.gru_step")


def tail(reg, out, carry=None, depth=None):
    """After prob_conv: reg (B, h, w, 1) bf16 -> out (B, h, w) float32; with
    `carry` (max_prob, depth_image, exp_sum), each (B, h, w, 1) float32, and
    `depth` (B,) float32 the winner-take-all update in place. One launch on
    a card."""
    if reg.device.type == "cpu":
        return tail_plain(reg, out, carry, depth)
    dev, lead = reg.device, tuple(out.shape)
    if reg.device.type != "cuda":
        raise ValueError(f"the GRU step kernels take CUDA tensors, got one on {dev}")
    _check("reg", reg, lead + (1,), torch.bfloat16, dev)
    _check("out", out, lead, torch.float32, dev)
    B = lead[0]
    P = out.numel() // B
    wta = [None] * 4
    if carry is not None:
        for t in carry:
            _check("a carry", t, lead + (1,), torch.float32, dev)
        _check("depth", depth, (B,), torch.float32, dev)
        wta = [t.data_ptr() for t in (*carry, depth)]
    grid = max(1, min(-(-B * P // _THREADS), 4096))
    err = _fn("tail_launch")(reg.data_ptr(), out.data_ptr(), *wta, B, P, grid, _lib.stream_of(reg))
    _lib.check("gru_step", err)
    profiling.count("launches.gru_step")
