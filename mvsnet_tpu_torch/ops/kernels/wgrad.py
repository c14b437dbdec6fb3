"""Weight gradient of a "SAME" convolution, rank 2 or 3: kernel K4w
(`csrc/wgrad.cu`).

Replaces the Pallas weight-gradient kernels of
mvsnet_tpu/ops/pallas/conv3d.py (`_pallas_wgrad_s1` at conv3d.py:1185,
`_pallas_wgrad_s2` at :1318) and serves the weight gradients the JAX
package leaves to XLA: the 2D convs and, with input and cotangent swapped,
the transposed convs (`ops/autograd.py`).

  dk[t, ci, co] = sum_{b, out} x[b, out * stride - pad_lo + t, ci] * g[b, out, co]

in float32. The kernel is a split-K product: one pass writes a partial dk
per (range of output voxels, tap) into a float32 workspace that this
wrapper allocates, a second launch adds the partials in a fixed order, so
the result does not change from run to run (see the source's comment).

`wgrad` runs the kernel on CUDA tensors and `wgrad_plain` on CPU tensors;
it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mvsnet_tpu_torch.ops.kernels import _lib
from mvsnet_tpu_torch.ops.kernels.conv import same_pads

# Calls of the CUDA kernel in this process (each is one partial pass and
# one reduction, launched by one C entry point).
launches = 0

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_I] * 6 + [_P] * 4 + [_I] * 17 + [_P]
_THREADS, _MAX_TILES = 256, 4          # csrc/wgrad.cu kThreads, kMaxTiles
_STAGE_BYTES = 32 * 1024               # shared memory for the staged rows
_BLOCKS = 4 * 132                      # blocks to aim for: 4 per H100 SM


def _geometry(x, g, ksize, stride):
    """Checks shapes; returns the low pads, one per spatial axis."""
    rank = x.ndim - 2
    if rank not in (2, 3) or g.ndim != x.ndim or len(ksize) != rank:
        raise ValueError(f"wgrad takes NHWC/NDHWC x and g and one kernel extent per "
                         f"axis, got {tuple(x.shape)}, {tuple(g.shape)}, {tuple(ksize)}")
    if stride not in (1, 2) or g.shape[0] != x.shape[0]:
        raise ValueError(f"stride {stride} or batch {g.shape[0]} != {x.shape[0]}")
    los = []
    for n, k, m in zip(x.shape[1:-1], ksize, g.shape[1:-1]):
        lo, _, out = same_pads(n, k, stride)
        if out != m:
            raise ValueError(f"cotangent {tuple(g.shape)} is not the SAME stride-"
                             f"{stride} output of {tuple(x.shape)}")
        los.append(lo)
    return los


def wgrad_plain(x, g, ksize, stride: int = 1):
    """Plain PyTorch version: for every tap, the strided slice of the
    zero-padded input times g, summed over the output voxels by one float32
    matrix product.

    x (B, [D,] H, W, Cin), g (B, [Do,] Ho, Wo, Cout), ksize ([KD,] KH, KW)
    -> ([KD,] KH, KW, Cin, Cout) float32.
    """
    los = _geometry(x, g, ksize, stride)
    cin, cout = x.shape[-1], g.shape[-1]
    pads = []
    for n, k, m, lo in zip(x.shape[1:-1], ksize, g.shape[1:-1], los):
        pads += [lo, max(0, (m - 1) * stride + k - lo - n)]
    flat = [p for i in reversed(range(len(ksize))) for p in pads[2 * i:2 * i + 2]]
    xp = torch.nn.functional.pad(x.to(torch.float32).movedim(-1, 1), flat).movedim(1, -1)
    g2 = g.to(torch.float32).reshape(-1, cout)
    out = torch.empty(tuple(ksize) + (cin, cout), dtype=torch.float32, device=x.device)
    for tap in torch.cartesian_prod(*[torch.arange(k) for k in ksize]).reshape(-1, len(ksize)):
        sl = tuple(slice(int(t), int(t) + (m - 1) * stride + 1, stride)
                   for t, m in zip(tap, g.shape[1:-1]))
        xs = xp[(slice(None),) + sl].reshape(-1, cin)
        out[tuple(int(t) for t in tap)] = xs.T @ g2
    return out


def wgrad(x, g, ksize, stride: int = 1):
    """Weight gradient of the SAME conv of x with a ([KD,] KH, KW, Cin,
    Cout) kernel at `stride`, given the cotangent g of its output:
    ([KD,] KH, KW, Cin, Cout) float32. x and g share one dtype."""
    global launches
    if x.device.type == "cpu":
        return wgrad_plain(x, g, ksize, stride)
    los = _geometry(x, g, ksize, stride)
    if g.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype} and g {g.dtype}")
    x = x.contiguous()
    g = g.contiguous()
    _lib.require_cuda(x, g)
    x5, g5 = (x[:, None], g[:, None]) if x.ndim == 4 else (x, g)
    kd, kh, kw = (1, *ksize) if x.ndim == 4 else tuple(ksize)
    pd, ph, pw = (0, *los) if x.ndim == 4 else tuple(los)
    sd = 1 if x.ndim == 4 else stride
    B, Di, Hi, Wi, cin = x5.shape
    Do, Ho, Wo, cout = g5.shape[1:]
    # one thread's register tile: 4 (or 1) input by 4 (or 1) output channels
    ti, to = (4 if cin % 4 == 0 else 1), (4 if cout % 4 == 0 else 1)
    if (cin // ti) * (cout // to) > _THREADS * _MAX_TILES:
        raise ValueError(f"wgrad takes at most {_THREADS * _MAX_TILES} register tiles, "
                         f"got {cin} x {cout} channels")
    n_out = B * Do * Ho * Wo
    rows = max(8, min(256, _STAGE_BYTES // (4 * (cin + cout) + 16)) // 4 * 4)
    taps = kd * kh * kw
    nsplit = max(1, min(math.ceil(_BLOCKS / taps), math.ceil(n_out / rows)))
    ws = torch.empty((nsplit, taps, cin, cout), dtype=torch.float32, device=x.device)
    out = torch.empty((kd, kh, kw, cin, cout), dtype=torch.float32, device=x.device)
    fn = _lib.launcher("wgrad", _ARGTYPES)
    err = fn(_lib.dtype_code(x), kd, kh, kw, ti, to, _lib.ptr(x5), _lib.ptr(g5),
             _lib.ptr(ws), _lib.ptr(out), B, Di, Hi, Wi, cin, Do, Ho, Wo, cout,
             sd, stride, stride, pd, ph, pw, rows, nsplit, _lib.stream_of(x))
    _lib.check("wgrad", err)
    launches += 1
    return out[0] if x.ndim == 4 else out
