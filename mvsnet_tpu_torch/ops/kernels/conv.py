"""Direct "SAME" convolution, rank 2 or 3, with a bias + ReLU epilogue:
kernels K4 and K6 (`csrc/conv.cu`, `csrc/tc_conv.cuh`).

Replaces the Pallas 3D conv kernels (mvsnet_tpu/ops/pallas/conv3d.py,
`_rowconv3d_fwd_impl` at conv3d.py:974: `_make_kernel`, `_make_kernel_dpack`,
`_make_kernel_packed`, `_make_kernel_s2`, `_make_kernel_s2_split`) and the
Pallas 2D conv kernels (mvsnet_tpu/ops/pallas/conv2d.py, `_rowconv2d_fwd_impl`
at conv2d.py:871, :825, :774, and `_rowconv2d_s2_fwd_impl` at :578). It also
serves the shapes the JAX package leaves to XLA: every conv of the path runs
here. Two editions (see the sources' notes):
- "tc", bf16 with Cout <= 128: an implicit GEMM on the tensor cores, the
  input box staged once per tile (a Cin that is not a multiple of 8
  zero-padded in shared memory), float32 sums;
- "simt", float32 (and bf16 where `edition="simt"` asks for it): the
  CUDA-core kernel, float32 sums in registers.
`edition=None` picks by that rule; asking for "tc" on operands it does not
take raises. Each launch counts in `launches.conv` and
`editions.conv.<edition>` (`utils/profiling.py`).

`conv` runs a kernel on CUDA tensors and `conv_plain` on CPU tensors; it
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from mvsnet_tpu_torch.ops.kernels import _lib, tc
from mvsnet_tpu_torch.utils import profiling

EDITIONS = ("tc", "simt")

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_I, _I, _I, _I, _I, _P, _P, _P, _P] + [_I] * 16 + [_P]
# (KD, KH, KW) extents the kernel is built for (1 x 1: CasMVSNet's FPN laterals).
_EXTENTS = {(3, 3, 3), (1, 3, 3), (1, 5, 5), (1, 1, 1)}


def same_pads(n: int, k: int, s: int):
    """TF/XLA "SAME": output ceil(n/s), low pad total // 2, high the rest."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2, out


def out_channel_tile(cout: int) -> int:
    """Output channels per thread: the largest of 8, 4, 2, 1 dividing Cout."""
    return next(c for c in (8, 4, 2, 1) if cout % c == 0)


def _check_args(x, kernel, bias, stride):
    rank = x.ndim - 2
    if rank not in (2, 3) or kernel.ndim != rank + 2:
        raise ValueError(f"conv takes NHWC/NDHWC input with an HWIO/DHWIO "
                         f"kernel, got {tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.shape[-2] != x.shape[-1]:
        raise ValueError(f"kernel input channels {kernel.shape[-2]} != "
                         f"input channels {x.shape[-1]}")
    if bias is not None and tuple(bias.shape) != (kernel.shape[-1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match "
                         f"{kernel.shape[-1]} output channels")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    return rank


def pick_edition(dtype, cin: int, cout: int, edition=None) -> str:
    """The edition that runs these operands: `edition`, or by the rule
    (bf16 with Cout <= 128 -> "tc", else "simt")."""
    if edition not in (None, *EDITIONS):
        raise ValueError(f"edition must be None, 'tc' or 'simt', got {edition!r}")
    if edition is None:
        return "tc" if tc.takes(dtype, cin, cout) else "simt"
    if edition == "tc" and not tc.takes(dtype, cin, cout):
        raise ValueError(f"the tensor-core edition takes bf16 with Cout <= {tc.MAX_COUT}, "
                         f"got {dtype}, Cin={cin}, Cout={cout}")
    return edition


def conv_pads(x_spatial, ks, stride: int, pads=None):
    """((lo, hi), ...) and the output size per spatial axis: SAME pads, or
    the explicit `pads` ((lo, hi) per axis, zeros read beyond the input)."""
    if pads is None:
        pads = [same_pads(n, k, stride)[:2] for n, k in zip(x_spatial, ks)]
    pads = [tuple(int(p) for p in lo_hi) for lo_hi in pads]
    if len(pads) != len(ks) or any(len(p) != 2 or min(p) < 0 for p in pads):
        raise ValueError(f"one (lo, hi) pad >= 0 per spatial axis, got {pads}")
    outs = [(n + lo + hi - k) // stride + 1 for n, k, (lo, hi) in zip(x_spatial, ks, pads)]
    if min(outs) < 1:
        raise ValueError(f"pads {pads} leave no output for input {tuple(x_spatial)}")
    return pads, outs


def conv_plain(x, kernel, bias=None, stride: int = 1, relu: bool = False, pads=None):
    """Plain PyTorch version: asymmetric SAME (or the explicit) pads, then
    `F.conv{2,3}d` with padding 0, in float32 on x's values and the kernel
    cast to x's dtype; + bias, ReLU, cast to x's dtype."""
    rank = _check_args(x, kernel, bias, stride)
    pads, _ = conv_pads(x.shape[1:-1], kernel.shape[:rank], stride, pads)
    flat_pads = [p for lo_hi in reversed(pads) for p in lo_hi]
    xf = F.pad(x.to(torch.float32).movedim(-1, 1), flat_pads)
    w = kernel.to(x.dtype).to(torch.float32).permute(rank + 1, rank, *range(rank))
    y = (F.conv3d if rank == 3 else F.conv2d)(xf, w, stride=stride)
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1, *([1] * rank))
    if relu:
        y = torch.relu(y)
    return y.movedim(1, -1).to(x.dtype).contiguous()


def conv(x, kernel, bias=None, stride: int = 1, relu: bool = False, pads=None,
         edition=None):
    """SAME conv of x (B, [D,] H, W, Cin) with kernel ([KD,] KH, KW, Cin,
    Cout), float32 sums; out = act(sum + bias) in x's dtype. The kernel is
    cast to x's dtype; bias is float32 or None. `pads`, ((lo, hi), ...)
    per spatial axis, replaces the SAME pads (the block halo convs of
    `parallel/halo.py`). `edition`: see the module docstring."""
    rank = _check_args(x, kernel, bias, stride)
    edition = pick_edition(x.dtype, x.shape[-1], kernel.shape[-1], edition)
    if x.device.type == "cpu":
        return conv_plain(x, kernel, bias, stride, relu, pads)
    x = x.contiguous()
    w = kernel.to(x.dtype).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    _lib.require_cuda(x, w, *([] if b is None else [b]))
    if rank == 2:
        x5 = x[:, None]
        kd, kh, kw = (1, *w.shape[:2])
        sd = 1
    else:
        x5 = x
        kd, kh, kw = w.shape[:3]
        sd = stride
    if (kd, kh, kw) not in _EXTENTS:
        raise ValueError(f"the conv kernel is built for extents {sorted(_EXTENTS)}, "
                         f"got {(kd, kh, kw)}")
    B, Di, Hi, Wi, Cin = x5.shape
    Cout = w.shape[-1]
    lo_hi, outs = conv_pads(x.shape[1:-1], w.shape[:rank], stride, pads)
    (pd, Do) = (lo_hi[0][0], outs[0]) if rank == 3 else (0, 1)
    (ph, pw), (Ho, Wo) = (p[0] for p in lo_hi[-2:]), outs[-2:]
    out = torch.empty((B, Do, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    if edition == "tc":
        cls = tc.TapClass(taps=(kd, kh, kw), pads=(pd, ph, pw), grid=(Do, Ho, Wo))
        tc.launch("conv", x5, w.reshape(kd, kh, kw, Cin, Cout), b, out, (sd, stride, stride),
                  (1, 1, 1), [cls], relu)
        profiling.count("launches.conv")
        profiling.count("editions.conv.tc")
        return out[:, 0] if rank == 2 else out
    # the float32 edition stages the weights as float32 in shared memory
    if 4 * math.prod((kd, kh, kw, Cin)) * out_channel_tile(Cout) > 227 * 1024:
        raise ValueError(f"weights of {Cin} input channels exceed the shared memory")
    fn = _lib.launcher("conv", _ARGTYPES)
    err = fn(_lib.dtype_code(x), kd, kh, kw, out_channel_tile(Cout), _lib.ptr(x5),
             _lib.ptr(w), None if b is None else _lib.ptr(b), _lib.ptr(out),
             B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, sd, stride, stride, pd, ph, pw,
             int(relu), _lib.stream_of(x))
    _lib.check("conv", err)
    profiling.count("launches.conv")
    profiling.count("editions.conv.simt")
    return out[:, 0] if rank == 2 else out
