"""3x3(x3) stride-2 transposed convolution with a bias + ReLU epilogue,
rank 2 or 3: kernels K5 and K7 (`csrc/deconv.cu`).

Replaces the Pallas deconv kernels of mvsnet_tpu/ops/pallas/deconv3d.py
(`_rowdeconv3d_fwd_impl` at deconv3d.py:194, `_make_kernel`) and
mvsnet_tpu/ops/pallas/deconv2d.py (`_rowdeconv2d_fwd_impl` at
deconv2d.py:185, `_make_kernel`): flax `ConvTranspose(3, 2, "SAME")`, that
is out[2i + d] += k[2 - d] * x[i] along every upsampled axis. Bound by bytes
on the H100's tensor cores; this first kernel gathers the (at most eight)
taps of each output on the CUDA cores, with no atomics, float32 sums and
the weights staged in shared memory (see the source's comment).

`deconv` runs the kernel on CUDA tensors and `deconv_plain` on CPU tensors;
it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mvsnet_tpu_torch.ops.kernels import _lib
from mvsnet_tpu_torch.ops.kernels.conv import out_channel_tile

# Launches of the CUDA kernel in this process.
launches = 0

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_I, _I, _I, _P, _P, _P, _P] + [_I] * 7 + [_P]


def _check_args(x, kernel, bias):
    rank = x.ndim - 2
    if rank not in (2, 3) or kernel.shape[:rank] != (3,) * rank or kernel.ndim != rank + 2:
        raise ValueError(f"deconv takes NHWC/NDHWC input with a 3x3(x3) flax "
                         f"kernel, got {tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.shape[-2] != x.shape[-1]:
        raise ValueError(f"kernel input channels {kernel.shape[-2]} != "
                         f"input channels {x.shape[-1]}")
    if bias is not None and tuple(bias.shape) != (kernel.shape[-1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match "
                         f"{kernel.shape[-1]} output channels")
    return rank


def deconv_plain(x, kernel, bias=None, relu: bool = False):
    """Plain PyTorch version: `F.conv_transpose{2,3}d` with the flax kernel
    flipped on every spatial axis, stride 2, padding 0, cropped to the
    first 2n of each axis; float32 on x's values and the kernel cast to x's
    dtype; + bias, ReLU, cast to x's dtype."""
    rank = _check_args(x, kernel, bias)
    xf = x.to(torch.float32).movedim(-1, 1)
    w = kernel.to(x.dtype).to(torch.float32).flip(list(range(rank)))
    w = w.permute(rank, rank + 1, *range(rank))                 # (Cin, Cout, k..)
    y = (F.conv_transpose3d if rank == 3 else F.conv_transpose2d)(xf, w, stride=2)
    y = y[(..., *(slice(0, 2 * n) for n in x.shape[1:-1]))]
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1, *([1] * rank))
    if relu:
        y = torch.relu(y)
    return y.movedim(1, -1).to(x.dtype).contiguous()


def deconv(x, kernel, bias=None, relu: bool = False):
    """k3 s2 transposed conv of x (B, [D,] H, W, Cin) with the flax kernel
    (3, 3, [3,] Cin, Cout) -> (B, [2D,] 2H, 2W, Cout) in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return deconv_plain(x, kernel, bias, relu)
    rank = _check_args(x, kernel, bias)
    x = x.contiguous()
    w = kernel.to(x.dtype).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    _lib.require_cuda(x, w, *([] if b is None else [b]))
    x5 = x[:, None] if rank == 2 else x
    B, Di, Hi, Wi, Cin = x5.shape
    Cout = w.shape[-1]
    cot = out_channel_tile(Cout)
    if 4 * 3 ** rank * Cin * cot > 227 * 1024:
        raise ValueError(f"weights of {Cin} input channels exceed the shared memory")
    Do = 2 * Di if rank == 3 else 1
    out = torch.empty((B, Do, 2 * Hi, 2 * Wi, Cout), dtype=x.dtype, device=x.device)
    fn = _lib.launcher("deconv", _ARGTYPES)
    err = fn(_lib.dtype_code(x), rank, cot, _lib.ptr(x5), _lib.ptr(w),
             None if b is None else _lib.ptr(b), _lib.ptr(out), B, Di, Hi, Wi,
             Cin, Cout, int(relu), _lib.stream_of(x))
    _lib.check("deconv", err)
    launches += 1
    return out[:, 0] if rank == 2 else out
