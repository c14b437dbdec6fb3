"""Stride-2 transposed convolution with a bias + ReLU epilogue, rank 2 or 3:
kernels K5 and K7 (`csrc/deconv.cu`).

Replaces the Pallas deconv kernels of mvsnet_tpu/ops/pallas/deconv3d.py
(`_rowdeconv3d_fwd_impl` at deconv3d.py:194, `_make_kernel`) and
mvsnet_tpu/ops/pallas/deconv2d.py (`_rowdeconv2d_fwd_impl` at
deconv2d.py:185, `_make_kernel`): flax `ConvTranspose(3, 2, "SAME")`, that
is out[2i + d] += k[2 - d] * x[i] along every upsampled axis. With a low-pad
offset `lo` and an output size it is the adjoint of a K x K stride-2 SAME
conv, K = 3 or (rank 2) 5: the input gradient of every stride-2 conv of the
path (`ops/autograd.py`). Bound by bytes on the H100. Two editions, picked
as for the direct conv (`conv.pick_edition`, argument `edition`):
- "tc", bf16 with Cout <= 128: the output's 2^rank parity classes
  (`tc.deconv_classes`), each a stride-1 implicit GEMM of the input with a
  slice of the kernel on the tensor cores, all in one launch (a Cin that is
  not a multiple of 8 zero-padded in shared memory);
- "simt", float32 (and bf16 where `edition="simt"` asks for it): one
  thread gathers the (at most (K + 1) / 2 per axis) taps of each output on
  the CUDA cores.
Neither uses atomics; sums are float32 (see the sources' notes).

`deconv` runs the kernel on CUDA tensors and `deconv_plain` on CPU tensors;
it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mvsnet_tpu_torch.ops.kernels import _lib, tc
from mvsnet_tpu_torch.ops.kernels.conv import out_channel_tile, pick_edition

# Launches of the CUDA kernels in this process, in all and per edition.
launches = 0
launches_by_edition = {"tc": 0, "simt": 0}

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_I, _I, _I, _I, _P, _P, _P, _P] + [_I] * 13 + [_P]
# kernel extents the kernel is built for, by rank
_EXTENTS = {3: (3,), 2: (3, 5)}


def _check_args(x, kernel, bias, lo, out_spatial):
    rank = x.ndim - 2
    k = kernel.shape[0] if kernel.ndim else 0
    if (rank not in _EXTENTS or kernel.ndim != rank + 2 or k not in _EXTENTS[rank]
            or kernel.shape[:rank] != (k,) * rank):
        raise ValueError(f"deconv takes NHWC/NDHWC input with a 3x3(x3) or 5x5 flax "
                         f"kernel, got {tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.shape[-2] != x.shape[-1]:
        raise ValueError(f"kernel input channels {kernel.shape[-2]} != "
                         f"input channels {x.shape[-1]}")
    if bias is not None and tuple(bias.shape) != (kernel.shape[-1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match "
                         f"{kernel.shape[-1]} output channels")
    los = (lo,) * rank if isinstance(lo, int) else tuple(lo)
    outs = (tuple(2 * n for n in x.shape[1:-1]) if out_spatial is None
            else tuple(out_spatial))
    if len(los) != rank or len(outs) != rank:
        raise ValueError(f"one low pad and one output size per axis, got {los}, {outs}")
    for n, lo_, m in zip(x.shape[1:-1], los, outs):
        if not (0 <= lo_ < k and 0 < m and lo_ + m <= 2 * (n - 1) + k):
            raise ValueError(f"output {m} at low pad {lo_} does not fit a stride-2 "
                             f"transposed conv of {n} inputs with K={k}")
    return rank, k, los, outs


def deconv_plain(x, kernel, bias=None, relu: bool = False, lo=0, out_spatial=None):
    """Plain PyTorch version: `F.conv_transpose{2,3}d` with the flax kernel
    flipped on every spatial axis, stride 2, padding 0, cropped to
    [lo, lo + out) on each axis; float32 on x's values and the kernel cast
    to x's dtype; + bias, ReLU, cast to x's dtype."""
    rank, _, los, outs = _check_args(x, kernel, bias, lo, out_spatial)
    xf = x.to(torch.float32).movedim(-1, 1)
    w = kernel.to(x.dtype).to(torch.float32).flip(list(range(rank)))
    w = w.permute(rank, rank + 1, *range(rank))                 # (Cin, Cout, k..)
    y = (F.conv_transpose3d if rank == 3 else F.conv_transpose2d)(xf, w, stride=2)
    y = y[(..., *(slice(a, a + m) for a, m in zip(los, outs)))]
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1, *([1] * rank))
    if relu:
        y = torch.relu(y)
    return y.movedim(1, -1).to(x.dtype).contiguous()


def deconv(x, kernel, bias=None, relu: bool = False, lo=0, out_spatial=None,
           edition=None):
    """Stride-2 transposed conv of x (B, [D,] H, W, Cin) with the flax kernel
    (K, K, [K,] Cin, Cout): out[o] = sum_t k[K-1-t] x[(o + lo - t) / 2] per
    axis, over the taps inside x. The defaults (lo 0, output 2n per axis)
    are flax's k3 s2 SAME transposed conv. Returns (B, *out_spatial, Cout)
    in x's dtype. `edition`: see the module docstring."""
    global launches
    rank, k, los, outs = _check_args(x, kernel, bias, lo, out_spatial)
    edition = pick_edition(x.dtype, x.shape[-1], kernel.shape[-1], edition)
    if x.device.type == "cpu":
        return deconv_plain(x, kernel, bias, relu, lo, out_spatial)
    x = x.contiguous()
    w = kernel.to(x.dtype).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    _lib.require_cuda(x, w, *([] if b is None else [b]))
    x5 = x[:, None] if rank == 2 else x
    B, Di, Hi, Wi, Cin = x5.shape
    Cout = w.shape[-1]
    (Do, lod) = (outs[0], los[0]) if rank == 3 else (1, 0)
    Ho, Wo = outs[-2:]
    loh, low = los[-2:]
    out = torch.empty((B, Do, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    if edition == "tc":
        classes = tc.deconv_classes(k, (Di, Hi, Wi), (lod, loh, low), (Do, Ho, Wo),
                                    (rank == 3, True, True))
        tc.launch("deconv", x5, w[None] if rank == 2 else w, b, out, (1, 1, 1),
                  (2 if rank == 3 else 1, 2, 2), classes, relu)
        launches += 1
        launches_by_edition["tc"] += 1
        return out[:, 0] if rank == 2 else out
    # the float32 edition stages the weights as float32 in shared memory
    cot = out_channel_tile(Cout)
    if 4 * k ** rank * Cin * cot > 227 * 1024:
        raise ValueError(f"weights of {Cin} input channels exceed the shared memory")
    fn = _lib.launcher("deconv", _ARGTYPES)
    err = fn(_lib.dtype_code(x), rank, k, cot, _lib.ptr(x5), _lib.ptr(w),
             None if b is None else _lib.ptr(b), _lib.ptr(out), B, Di, Hi, Wi,
             Cin, Do, Ho, Wo, Cout, lod, loh, low, int(relu), _lib.stream_of(x))
    _lib.check("deconv", err)
    launches += 1
    launches_by_edition["simt"] += 1
    return out[:, 0] if rank == 2 else out
