"""Weight gradient of a "SAME" convolution, rank 2 or 3: kernel K4w
(`csrc/wgrad.cu`).

Replaces the Pallas weight-gradient kernels of
mvsnet_tpu/ops/pallas/conv3d.py (`_pallas_wgrad_s1` at conv3d.py:1185,
`_pallas_wgrad_s2` at :1318) and serves the weight gradients the JAX
package leaves to XLA: the 2D convs and, with input and cotangent swapped,
the transposed convs (`ops/autograd.py`).

  dk[t, ci, co] = sum_{b, out} x[b, out * stride - pad_lo + t, ci] * g[b, out, co]

in float32. Both editions are split-K products: one pass writes partial
dk's into a float32 workspace that this wrapper allocates, a second launch
adds them in a fixed order, so the result does not change from run to run.
Two editions (see the source's note):
- "tc", bf16 with Cin % 8 == 0: the tensor-core kernel, each block staging
  an input box and a cotangent tile once for all taps (a Cout that is not
  a multiple of 8, 3dconv6_2's 1, zero-padded to 8 columns in shared
  memory); `tc_plan` picks its tiling (plain Python, which the CPU tests
  reach);
- "simt", float32, and bf16 with Cin % 8 != 0 (the two convs on the
  3-channel images): the CUDA-core kernel, which gathers the input once
  per tap.
`edition=None` picks by that rule; asking for "tc" on operands it does not
take raises. `launches` counts every launch, `launches_by_edition` each
edition's.

`wgrad` runs a kernel on CUDA tensors and `wgrad_plain` on CPU tensors; it
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from mvsnet_tpu_torch.ops.kernels import _lib
from mvsnet_tpu_torch.ops.kernels.conv import same_pads
from mvsnet_tpu_torch.ops.kernels.tc import SMEM_LIMIT, SMS

# Calls of the CUDA kernels in this process, in all and per edition (each
# is one partial pass and one reduction, launched by one C entry point).
launches = 0
launches_by_edition = {"tc": 0, "simt": 0}
EDITIONS = ("tc", "simt")

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_I] * 6 + [_P] * 4 + [_I] * 17 + [_P]
_THREADS, _MAX_TILES = 256, 4          # csrc/wgrad.cu kThreads, kMaxTiles
_STAGE_BYTES = 32 * 1024               # shared memory for the staged rows
_BLOCKS = 4 * 132                      # blocks to aim for: 4 per H100 SM

# ---- the tensor-core edition's plan (csrc/wgrad.cu `TcPlan`)
SMEM_SM = 228 * 1024                   # shared memory of an H100 SM
TC_WARPS = 8                           # warps a block (kTcWarps)
# column tiles of 8 a block (its Cout slice) -> row tiles of 16 a warp, as
# csrc/wgrad.cu `wgrad_tc_launch` instantiates them
TC_TILES = {1: (1, 2, 4, 7), 2: (1, 2, 4, 7), 4: (1, 2, 4), 8: (1, 2)}
WS_LIMIT = 256 * 2 ** 20               # workspace bytes a plan may ask for
FASTDIV_LIMIT = 2 ** 17                # csrc/tc_conv.cuh FastDiv is exact below
# nt, mt, plan, x, g, ws, out, stream
_TC_ARGTYPES = [_I, _I] + [_P] * 6


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


def takes_tc(dtype, cin: int, cout: int) -> bool:
    """Whether the tensor-core edition takes these operands."""
    return dtype == torch.bfloat16 and cin % 8 == 0


def pick_edition(dtype, cin: int, cout: int, edition=None) -> str:
    """The edition that runs these operands: `edition`, or by the rule
    (bf16 with Cin % 8 == 0 -> "tc", else "simt")."""
    if edition not in (None, *EDITIONS):
        raise ValueError(f"edition must be None, 'tc' or 'simt', got {edition!r}")
    if edition is None:
        return "tc" if takes_tc(dtype, cin, cout) else "simt"
    if edition == "tc" and not takes_tc(dtype, cin, cout):
        raise ValueError(f"the tensor-core edition takes bf16 with Cin % 8 == 0, got "
                         f"{dtype}, Cin={cin}, Cout={cout}")
    return edition


@dataclasses.dataclass(frozen=True)
class TcPlan:
    nt: int              # column tiles of 8 a block: its Cout slice
    mt: int              # row tiles of 16 a warp
    kg: int              # warp groups along k (each takes every kg-th k step)
    tile: tuple          # (TZ, TY, TX) output voxels a tile
    box: tuple           # (BZ, BY, BX) input pixels staged a tile
    m_slices: int        # row-tile slices over blockIdx.y
    n_slices: int        # Cout slices over blockIdx.y
    grid_x: int          # persistent blocks a slice
    box_bytes: int       # one buffer's box and cotangent tile; a block has two
    g_bytes: int
    smem_bytes: int

    @property
    def wm(self) -> int:
        return TC_WARPS // self.kg

    @property
    def ksteps(self) -> int:
        return math.prod(self.tile) // 16


def _ceil(a, b):
    return -(-a // b)


def _pow2_at_least(n):
    v = 1
    while v < n:
        v *= 2
    return v


def tc_regs(nt: int, mt: int) -> int:
    """Registers a thread of the tc kernel takes, about: the float32
    partials, the fragments, the lane's row addresses and 40 of its own."""
    return 40 + 4 * mt * nt + 6 * mt + 2 * nt


def tc_candidates(x5_shape, g5_shape, taps, strides, los):
    """(cost, TcPlan) of every feasible tiling. The cost counts SM clock
    cycles: per tile, the shared-memory wavefronts of the fragment loads (4
    a 16 x 16 input fragment, 2 a cotangent fragment pair) against 1.5 a
    product, and the staged bytes at 24 bytes a clock (overlapped with the
    products by the two buffers, a quarter of the shorter still counted);
    the tiles a block walks, the blocks an SM holds, and the second pass
    over the workspace."""
    B, _, _, _, cin = x5_shape
    _, Do, Ho, Wo, cout = g5_shape
    nch, gch = cin // 8, _ceil(cout, 8)
    n_taps = math.prod(taps)
    units = n_taps * nch
    m_tiles = _ceil(units, 2)
    tiles = []
    for tx in (8, 16, 32, 64):
        if tx > max(8, _ceil(Wo, 8) * 8):
            continue
        for ty in (1, 2, 4, 8, 16, 32, 64):
            if ty > _pow2_at_least(Ho):
                continue
            for tz in ((1, 2, 4, 8) if Do > 1 else (1,)):
                if tz > _pow2_at_least(Do):
                    continue
                m = tz * ty * tx
                if m % 16 == 0 and m <= 1024:
                    tiles.append((tz, ty, tx))
    for nt in TC_TILES:
        if nt > _pow2_at_least(gch):
            continue
        n_slices = _ceil(gch, nt)
        for mt in TC_TILES[nt]:
            regs = -(-tc_regs(nt, mt) // 8) * 8
            by_regs = 65536 // (32 * TC_WARPS * regs)
            if by_regs < 1:
                continue
            for kg in (1, 2, 4, 8):
                wm = TC_WARPS // kg
                m_slices = _ceil(m_tiles, wm * mt)
                # no warp group of a slice left idle
                if m_slices * wm * mt - m_tiles >= mt * max(1, wm // 2) and wm > 1:
                    continue
                for tile in tiles:
                    ks = math.prod(tile) // 16
                    if ks % kg:
                        continue
                    box = tuple((t - 1) * s + k for t, s, k in zip(tile, strides, taps))
                    if math.prod(box) * nch >= FASTDIV_LIMIT:
                        continue
                    box_bytes = _ceil(math.prod(box) * cin * 2, 128) * 128
                    g_bytes = _ceil(math.prod(tile) * nt * 16, 128) * 128
                    n_tiles = B * math.prod(_ceil(n, t) for n, t in zip((Do, Ho, Wo), tile))
                    grid_y = m_slices * n_slices
                    mt_slice = m_tiles / m_slices
                    comp = max(ks * (mt_slice * 4 + wm * max(2, 2 * nt)), ks * mt_slice * nt * 1.5)
                    copies = math.prod(box) * nch + math.prod(tile) * nt
                    stage = max((box_bytes + g_bytes) / 24, copies * 25 / 128)
                    smem = 2 * (box_bytes + g_bytes)
                    if smem > SMEM_LIMIT:
                        continue
                    conc = max(1, min(SMEM_SM // (smem + 1024), by_regs, 64 // TC_WARPS))
                    grid_x = max(1, min(n_tiles, SMS * conc // grid_y))
                    ws_bytes = grid_x * kg * units * 8 * cout * 4
                    if ws_bytes > WS_LIMIT:
                        continue
                    # the copies hide under the products, but their share of
                    # L2's bandwidth still counts a quarter
                    tile_cyc = max(comp, stage) + 0.25 * min(comp, stage)
                    eff = min(1.0, conc * TC_WARPS / 16)
                    blocks_on_sm = _ceil(grid_x * grid_y, SMS)
                    cost = (blocks_on_sm * _ceil(n_tiles, grid_x) * tile_cyc / eff
                            + ws_bytes / 1900 + 2 * units * 8 * cout)
                    yield ((cost, m_slices * n_slices, -math.prod(tile)),
                           TcPlan(nt=nt, mt=mt, kg=kg, tile=tile, box=box, m_slices=m_slices,
                                  n_slices=n_slices, grid_x=grid_x, box_bytes=box_bytes,
                                  g_bytes=g_bytes, smem_bytes=smem))


@functools.lru_cache(maxsize=256)
def tc_plan(x5_shape, g5_shape, taps, strides, los) -> TcPlan:
    """The cheapest feasible tiling of `tc_candidates` (cached per shape)."""
    best = min(tc_candidates(tuple(x5_shape), tuple(g5_shape), tuple(taps), tuple(strides),
                             tuple(los)), key=lambda kp: kp[0], default=None)
    if best is None:
        raise ValueError(f"no tile of the tensor-core weight gradient fits x {x5_shape}, "
                         f"g {g5_shape}")
    return best[1]


def plan_ints(p: TcPlan, x5_shape, g5_shape, taps, strides, los):
    """The 39 ints of csrc/wgrad.cu's `TcPlan`."""
    B, Di, Hi, Wi, cin = x5_shape
    _, Do, Ho, Wo, cout = g5_shape
    counts = [_ceil(n, t) for n, t in zip((Do, Ho, Wo), p.tile)]
    units = math.prod(taps) * cin // 8
    ints = [B, Di, Hi, Wi, cin, Do, Ho, Wo, cout, *taps, *strides, *los, *p.tile, *p.box,
            *counts, B * math.prod(counts), p.ksteps, p.kg, p.wm, units, _ceil(units, 2),
            p.m_slices, p.box_bytes, p.g_bytes, p.smem_bytes, p.grid_x,
            p.m_slices * p.n_slices]
    return np.asarray(ints, dtype=np.int32)


@functools.lru_cache(maxsize=256)
def _prepared(x5_shape, g5_shape, taps, strides, los):
    p = tc_plan(x5_shape, g5_shape, taps, strides, los)
    return p, plan_ints(p, x5_shape, g5_shape, taps, strides, los)


def wgrad(x, g, ksize, stride: int = 1, edition=None):
    """Weight gradient of the SAME conv of x with a ([KD,] KH, KW, Cin,
    Cout) kernel at `stride`, given the cotangent g of its output:
    ([KD,] KH, KW, Cin, Cout) float32. x and g share one dtype.
    `edition`: see the module docstring."""
    global launches
    edition = pick_edition(x.dtype, x.shape[-1], g.shape[-1], edition)
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
    if edition == "tc":
        p, ints = _prepared(tuple(x5.shape), tuple(g5.shape), (kd, kh, kw),
                            (sd, stride, stride), (pd, ph, pw))
        ws = torch.empty((p.grid_x * p.kg, kd * kh * kw, cin, cout), dtype=torch.float32,
                         device=x.device)
        out = torch.empty((kd, kh, kw, cin, cout), dtype=torch.float32, device=x.device)
        fn = _lib.launcher("wgrad", _TC_ARGTYPES, entry="tc_launch")
        err = fn(p.nt, p.mt, ints.ctypes.data_as(ctypes.c_void_p), _lib.ptr(x5), _lib.ptr(g5),
                 _lib.ptr(ws), _lib.ptr(out), _lib.stream_of(x))
        _lib.check("wgrad", err)
        launches += 1
        launches_by_edition["tc"] += 1
        return out[0] if x.ndim == 4 else out
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
    launches_by_edition["simt"] += 1
    return out[0] if x.ndim == 4 else out
