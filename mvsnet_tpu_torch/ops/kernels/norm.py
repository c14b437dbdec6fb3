"""Group norm of a half-precision map: a pair of kernels
(`csrc/group_norm.cu`), its statistics and its normalisation.

Replaces no TPU kernel: the JAX package leaves its group norm to XLA. On
the card the plain half-precision branch of `models/layers.group_norm_core`
makes about twenty launches and ten passes over the map a norm; the pair
makes two launches and reads x twice, writes y once:
- the stats kernel: the (2, N, C) float64 sums of x and x^2 over the
  pixels, summed over many blocks and added in a fixed order (two calls
  are equal bit for bit);
- the apply kernel: each (image, group)'s mean and variance from those
  sums and the pixel count, then `(x - mean) * rsqrt(var + eps) * gamma +
  beta` in float32, cast to x's dtype, and the ReLU of the layer after the
  norm where `relu`.
`group_norm` runs both with the block path's `stat_sum` between them, and
`group_norm_stats` the first alone; both take CUDA tensors only.

The plain pair `group_norm_stats_plain` / `group_norm_apply_plain`, with
`summed_over_blocks` between them, is `group_norm_core`'s half-precision
branch wherever the kernels do not run, and their reference on the card.
`launches.group_norm` (`utils/profiling.py`) counts the kernels' launches,
two a norm.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mvsnet_tpu_torch.ops.kernels import _lib
from mvsnet_tpu_torch.utils import profiling

_HALF = {torch.bfloat16: 1, torch.float16: 2}     # csrc/group_norm.cu DType
_THREADS = 256                                    # csrc/group_norm.cu kThreads
_UNROLL = 4                                       # csrc/group_norm.cu kUnroll
_MAX_GROUPS = 2048

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_ARGTYPES = {
    "stats_launch": [_I, _I, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    "apply_launch": [_I, _I, _P, _P, _P, ctypes.c_double, _P, _P, _P, _I, _L, _I, _I,
                     ctypes.c_float, _I, _I, _L, _P],
    "capacity": [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}
_fns: dict = {}
# (device index, dtype, channels a thread moves, C) -> the blocks of the
# stats and the apply kernel that the device holds at once
_capacity: dict = {}
# (device index, stream handle) -> the stats kernel's ticket: one counter
# that its last block resets, so every launch on a stream finds it zero.
_tickets: dict = {}


def _fn(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        fn = _fns[entry] = _lib.launcher("group_norm", _ARGTYPES[entry], entry=entry)
    return fn


def group_norm_stats_plain(x):
    """x (N, ..., C) bfloat16 or float16 -> (2, N, C) float64: the sums of
    x and of x^2 (exact in float32) over every axis but the first and last."""
    xf = x.to(torch.float32)
    spatial = tuple(range(1, x.ndim - 1))
    return torch.stack([xf.sum(dim=spatial, dtype=torch.float64),
                        (xf * xf).sum(dim=spatial, dtype=torch.float64)])


def group_norm_apply_plain(x, sums, count, gamma, beta, num_groups: int, eps: float,
                           relu: bool = False):
    """The norm of x (N, ..., C) from its sums (2, N, C) over `count` pixels
    (an int, or a float64 tensor of one element): per group mean = S / n
    and var = Q / n - mean^2 in float64, cast to float32; then in float32
    (x - mean) * rsqrt(var + eps) * gamma + beta, cast to x's dtype, and
    max(y, 0) where `relu`. Channel c is in group c // (C // G)."""
    N, C = x.shape[0], x.shape[-1]
    G = num_groups
    bshape = (N,) + (1,) * (x.ndim - 2) + (C,)
    group = sums.reshape(2, N, G, C // G).sum(dim=3) / (count * (C // G))      # (2, N, G)
    moments = torch.stack([group[0], group[1] - group[0] * group[0]]).to(torch.float32)
    mean, var = (m[:, :, None].expand(N, G, C // G).reshape(bshape) for m in moments)
    y = ((x.to(torch.float32) - mean) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)
    return torch.relu(y) if relu else y


def _geometry(x):
    """(N, pixels an image, C, channels a thread moves at once, and for the
    stats and the apply kernel (blocks an image, pixels a block)) of a
    contiguous half-precision CUDA map; raises on what the kernels do not
    take. Each kernel's grid is about the blocks the card holds at once
    (one wave), each block at least one pass of its threads' loads."""
    if x.device.type != "cuda" or x.dtype not in _HALF:
        raise ValueError(f"the group-norm kernels take bfloat16 or float16 CUDA maps, got "
                         f"{x.dtype} on {x.device}")
    if not x.is_contiguous() or x.ndim < 3 or x.numel() == 0:
        raise ValueError(f"the group-norm kernels take contiguous non-empty (N, ..., C) maps, "
                         f"got {tuple(x.shape)}")
    N, C = x.shape[0], x.shape[-1]
    vec = next(v for v in (8, 4, 2, 1) if C % v == 0 and x.data_ptr() % (2 * v) == 0)
    if C // vec > _THREADS or N > 65535:
        raise ValueError(f"the group-norm kernels take up to {_THREADS} lanes of channels "
                         f"and 65535 images, got C={C} ({vec} a lane) and N={N}")
    key = (x.device.index, x.dtype, vec, C)
    cap = _capacity.get(key)
    if cap is None:
        a, b = _I(), _I()
        with torch.cuda.device(x.device):   # the query reads the current device
            _lib.check("group_norm", _fn("capacity")(_HALF[x.dtype], vec, C, ctypes.byref(a),
                                                     ctypes.byref(b)))
        cap = _capacity[key] = (a.value, b.value)
    P = x.numel() // (N * C)
    most = -(-P // (_THREADS // (C // vec) * _UNROLL))
    grids = []
    for c in cap:
        span = -(-P // min(most, max(1, c // N)))
        grids.append((-(-P // span), span))
    return N, P, C, vec, grids


def _stats(x, N, P, C, vec, grid, stream):
    B, span = grid
    part = torch.empty((2, N, B, C), dtype=torch.float64, device=x.device)
    sums = torch.empty((2, N, C), dtype=torch.float64, device=x.device)
    key = (x.device.index, stream)
    ticket = _tickets.get(key)
    if ticket is None:
        ticket = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=x.device)
    err = _fn("stats_launch")(_HALF[x.dtype], vec, x.data_ptr(), part.data_ptr(),
                              sums.data_ptr(), ticket.data_ptr(), N, P, C, B, span, stream)
    _lib.check("group_norm", err)
    profiling.count("launches.group_norm")
    return sums


def _apply(x, sums, count, gamma, beta, G, eps, relu, N, P, C, vec, grid, stream):
    if not 1 <= G <= _MAX_GROUPS or C % G:
        raise ValueError(f"{G} groups do not divide {C} channels (at most {_MAX_GROUPS})")
    for name, t, shape, dtype in (("sums", sums, (2, N, C), torch.float64),
                                  ("gamma", gamma, (C,), torch.float32),
                                  ("beta", beta, (C,), torch.float32)):
        if t.device != x.device or t.shape != shape or t.dtype != dtype or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if isinstance(count, torch.Tensor):
        if count.device != x.device or count.dtype != torch.float64 or count.numel() != 1:
            raise ValueError("a tensor count must be one float64 on x's device")
        count_ptr, inv = count.data_ptr(), 0.0
    else:      # PyTorch divides by a host number as a product with its reciprocal
        count_ptr, inv = None, 1.0 / (count * (C // G))
    y = torch.empty_like(x)
    err = _fn("apply_launch")(_HALF[x.dtype], vec, x.data_ptr(), sums.data_ptr(), count_ptr,
                              inv, gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), N, P, C, G,
                              eps, int(relu), *grid, stream)
    _lib.check("group_norm", err)
    profiling.count("launches.group_norm")
    return y


def group_norm_stats(x):
    """(2, N, C) float64 sums of a half-precision CUDA x and x^2 over its
    pixels, in the kernel's fixed order; see `group_norm_stats_plain`. One
    launch."""
    x = x.contiguous()
    N, P, C, vec, grids = _geometry(x)
    return _stats(x, N, P, C, vec, grids[0], torch.cuda.current_stream(x.device).cuda_stream)


def group_norm(x, gamma, beta, num_groups: int, eps: float, relu: bool = False,
               stat_sum=None):
    """Group norm of a half-precision CUDA x (N, ..., C), the plain pair's
    arithmetic, and a ReLU where `relu`: the sums, then (with `stat_sum`, a
    block of the map's rows) those sums and the count summed over the
    blocks, then the normalisation. Two launches."""
    x = x.contiguous()
    N, P, C, vec, grids = _geometry(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sums, count = summed_over_blocks(_stats(x, N, P, C, vec, grids[0], stream),
                                     math.prod(x.shape[1:-1]), stat_sum)
    return _apply(x, sums, count, gamma.contiguous(), beta.contiguous(), num_groups, eps, relu,
                  N, P, C, vec, grids[1], stream)


def summed_over_blocks(sums, count, stat_sum):
    """A block's sums and count, and with `stat_sum` both summed over the
    blocks: the count made on the device (no sync)."""
    if stat_sum is None:
        return sums, count
    total = stat_sum(torch.cat([sums.reshape(-1), sums.new_full((1,), count)]))
    return total[:-1].reshape(sums.shape), total[-1:]
