"""Launch plans of the tensor-core edition of the conv and transposed-conv
kernels (`csrc/tc_conv.cuh`), and its launch.

A plan is a list of tap classes, each a strided conv over a grid of outputs
that lands at out[grid * ostride + offset]: one class for a conv, one per
output parity for a stride-2 transposed conv (`deconv_classes`). `plan`
picks the tile (rows per warp, tile shape, weights resident or streamed)
that a simple cost model of staged bytes and tile waves prefers, and lays
out the block's shared memory. A Cin that is not a multiple of 8 is
zero-padded in shared memory to ceil(Cin / 8) chunks a pixel. All of it is
plain Python, which the CPU tests reach; only `launch` needs the card.

`deconv_by_classes` runs a transposed conv class by class with plain
PyTorch convs: the CPU's check that the class table is the transposed conv.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mvsnet_tpu_torch.ops.kernels import _lib

SMEM_LIMIT = 227 * 1024       # bytes a block may use on the H100
SMS = 132                     # streaming multiprocessors on the H100
MAX_CLASSES = 8
MAX_TAPS = 32
# column tiles of 8 (N = 8 NT) -> (row tiles of 16 per warp, warps per
# block) the kernel is built for (csrc/tc_conv.cuh `launch`)
TILE_CHOICES = {1: ((8, 4), (4, 4), (2, 4), (4, 8), (2, 8)),
                2: ((4, 4), (2, 4), (1, 4), (2, 8), (1, 8)),
                4: ((4, 4), (2, 4), (1, 4), (2, 8), (1, 8)),
                8: ((2, 4), (1, 4), (1, 8)),
                16: ((2, 4), (1, 4), (1, 8))}
MAX_COUT = 8 * max(TILE_CHOICES)

# nt, mt, plan, x, w, bias, out, stream
_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6


@dataclasses.dataclass(frozen=True)
class TapClass:
    """Outputs grid (Dc, Hc, Wc) at out[g * ostride + offset], each the sum
    over taps (kd, kh, kw) of x[g * stride - pads + tap] with the kernel
    slice w[start::step] along each axis (step 1 for a conv; the kernel
    takes the step to be the output stride)."""
    taps: tuple
    pads: tuple
    grid: tuple
    offset: tuple = (0, 0, 0)
    start: tuple = (0, 0, 0)
    step: tuple = (1, 1, 1)

    @property
    def n_taps(self) -> int:
        return math.prod(self.taps)


def n_tiles_of(cout: int) -> int:
    """NT: column tiles of 8 covering Cout, a power of two up to 16."""
    return next(nt for nt in TILE_CHOICES if 8 * nt >= cout)


def weight_row_stride(nt: int) -> int:
    """Elements per shared-memory row of weights and of the output stage
    (csrc/tc_conv.cuh WS)."""
    return 8 if nt == 1 else 8 * nt + 8


def takes(dtype, cin: int, cout: int) -> bool:
    """Whether the tensor-core edition takes these operands: bf16 at any
    Cin (one not a multiple of 8 is zero-padded in shared memory) and
    0 < Cout <= MAX_COUT."""
    return dtype == torch.bfloat16 and cin > 0 and 0 < cout <= MAX_COUT


def deconv_classes(k: int, ins, los, outs, upsampled):
    """The parity classes of a stride-2 transposed conv, per axis of
    (D, H, W): out[o] = sum_t k[K-1-t] x[(o + lo - t) / 2] over t with
    o + lo - t even. Output o = 2 j + r takes the taps t = r + lo (mod 2),
    whose kernel indices K-1-t form the slice [s::2], s = (K-1-r-lo) % 2,
    at input offsets j + (r + lo - t) / 2: a stride-1 conv over j with low
    pad -(r + lo - t_max) / 2. An axis that is not upsampled (a 2D conv's
    depth) is one class of one tap."""
    return _deconv_classes(int(k), tuple(ins), tuple(los), tuple(outs), tuple(upsampled))


@functools.lru_cache(maxsize=256)
def _deconv_classes(k, ins, los, outs, upsampled):
    per_axis = []
    for n, lo, m, up in zip(ins, los, outs, upsampled):
        if not up:
            per_axis.append([(0, 0, 1, 0, m, 1)])
            continue
        cls = []
        for r in (0, 1):
            count = (m - r + 1) // 2
            if count <= 0:
                continue
            ts = [t for t in range(k) if (t - r - lo) % 2 == 0]
            pad = -((r + lo - max(ts)) // 2)
            cls.append((r, (k - 1 - r - lo) % 2, len(ts), pad, count, 2))
        per_axis.append(cls)
    out = []
    for cz in per_axis[0]:
        for cy in per_axis[1]:
            for cx in per_axis[2]:
                axes = (cz, cy, cx)
                out.append(TapClass(taps=tuple(a[2] for a in axes),
                                    pads=tuple(a[3] for a in axes),
                                    grid=tuple(a[4] for a in axes),
                                    offset=tuple(a[0] for a in axes),
                                    start=tuple(a[1] for a in axes),
                                    step=tuple(a[5] for a in axes)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Plan:
    nt: int
    mt: int
    warps: int
    tile: tuple          # (TZ, TY, TX) outputs
    box: tuple           # (BZ, BY, BX) input pixels staged per tile
    stream: int          # taps per streamed weight slice (0: resident weights)
    smem_bytes: int
    w_smem_off: int
    zero_off: int
    toff_off: int
    kpad: int            # resident weight rows (a multiple of 16)
    tiles: tuple         # per class (tz, ty, tx)
    grid_x: int          # tiles in all: the most persistent blocks worth launching
    box_bytes: int       # one box buffer (the output stage reuses it)
    nbuf: int = 1        # box buffers
    persist: bool = False  # blocks walk tiles (else one block per tile)
    nch: int = 0         # 16-byte chunks a box pixel holds: ceil(Cin / 8)


def _pow2_up_to(n):
    v = 1
    while v <= n:
        yield v
        v *= 2


def plan(cin: int, cout: int, strides, classes, batch: int = 1) -> Plan:
    """The cheapest feasible tiling of `candidates` (cached per shape)."""
    return _plan(int(cin), int(cout), tuple(strides), tuple(classes), int(batch))


@functools.lru_cache(maxsize=256)
def _plan(cin, cout, strides, classes, batch):
    best = min(candidates(cin, cout, strides, classes, batch), key=lambda kp: kp[0],
               default=None)
    if best is None:
        raise ValueError(f"no tile of Cin={cin}, Cout={cout} fits the shared memory")
    return best[1]


def blocks_per_sm(p: Plan) -> int:
    """Blocks of this plan an SM holds at once: by shared memory, by
    registers (about 40 + 4 MT (NT + 1) a thread, from the build's
    register counts) and by warps (64 an SM)."""
    regs = 40 + 4 * p.mt * (p.nt + 1)
    return max(1, min(SMEM_LIMIT // p.smem_bytes, 65536 // (32 * p.warps * regs),
                      64 // p.warps))


def candidates(cin: int, cout: int, strides, classes, batch: int = 1):
    """(cost, Plan) of every feasible tiling of `batch` elements. The
    model's constants are fitted to chip timings of every conv shape of a
    request (H100): a tile costs one unit per row and k step plus 0.1 per
    staged box byte, twice that where Cin % 8 != 0 gathers it element by
    element (the larger of the two where the box is double-
    buffered) plus 20000, and 8000 per streamed weight slice; tiles run
    in waves of SMS x (blocks at once on an SM: all it holds when
    persistent, else at most 2), slowed where those blocks hold fewer than
    8 warps."""
    if not 1 <= len(classes) <= MAX_CLASSES:
        raise ValueError(f"{len(classes)} tap classes")
    nt = n_tiles_of(cout)
    ws = weight_row_stride(nt)
    taps_max = max(c.n_taps for c in classes)
    if taps_max > MAX_TAPS - 1:
        raise ValueError(f"{taps_max} taps exceed the kernel's table")
    nch = -(-cin // 8)                             # a pixel's chunks, zero past Cin
    kpad = -(-taps_max * nch * 8 // 16) * 16
    deep = any(c.grid[0] > 1 for c in classes)     # tiles split the depth too
    ksteps = max(-(-c.n_taps * nch // 2) for c in classes)
    tail = 16 + 4 * MAX_TAPS                       # zero row, tap table

    for mt, warps in TILE_CHOICES[nt]:
        m = 16 * warps * mt
        for tz in (_pow2_up_to(m) if deep else (1,)):
            for ty in _pow2_up_to(m // tz):
                tx = m // (tz * ty)
                # no slivers: their halo costs more than the model sees
                if not 4 <= tx <= 64 or ty < 4 or tz * ty * tx != m:
                    continue
                tile = (tz, ty, tx)
                box = tuple(max((t - 1) * s + c.taps[a] for c in classes)
                            for a, (t, s) in enumerate(zip(tile, strides)))
                box_bytes = math.prod(box) * nch * 16
                region0 = -(-max(box_bytes, m * ws * 2) // 16) * 16
                tiles = [tuple(-(-g // t) for g, t in zip(c.grid, tile)) for c in classes]
                n_tiles = sum(math.prod(t) for t in tiles)
                # stream: taps per streamed weight slice (0: resident); nbuf
                # = 2: the next tile's box copies run under this tile's
                # products (resident weights only)
                plane = max(c.taps[1] * c.taps[2] for c in classes)
                for stream, nbuf in ((0, 1), (0, 2), (1, 1), (plane, 1)):
                    # a streamed slice is whole k steps of taps: nch even
                    if stream and (nch % 2 or stream >= taps_max):
                        continue
                    w_bytes = (2 * stream * nch * 8 if stream else kpad) * ws * 2
                    smem = nbuf * region0 + w_bytes + tail
                    if smem > SMEM_LIMIT:
                        continue
                    # a second box buffer serves only a block that walks tiles
                    for persist in ((True,) if nbuf == 2 else (False, True)):
                        p = Plan(nt=nt, mt=mt, warps=warps, tile=tile, box=box, stream=stream,
                                 smem_bytes=smem, w_smem_off=nbuf * region0,
                                 zero_off=nbuf * region0 + w_bytes,
                                 toff_off=nbuf * region0 + w_bytes + 16, kpad=kpad,
                                 tiles=tuple(tiles), grid_x=n_tiles * batch, box_bytes=region0,
                                 nbuf=nbuf, persist=persist, nch=nch)
                        # blocks that run at once on an SM, and the share of
                        # its issue rate they reach (8 warps saturate it)
                        conc = blocks_per_sm(p) if persist else min(2, blocks_per_sm(p))
                        eff = min(1.0, conc * warps / 8)
                        k_cost = m * ksteps
                        box_cost = (0.1 if cin % 8 == 0 else 0.2) * box_bytes
                        tile_cost = ((max(k_cost, box_cost) if nbuf == 2 else k_cost + box_cost)
                                     + 20000 + 8000 * (-(-taps_max // stream) if stream else 0))
                        cost = -(-n_tiles * batch // (SMS * conc)) * tile_cost / eff
                        yield (cost, stream, -nbuf, persist, -m), p


def plan_ints(p: Plan, x5_shape, out5_shape, k5_shape, strides, ostrides, classes,
              relu: bool):
    """The 200 ints of csrc/tc_conv.cuh's `Plan`: 40 header ints, then 20
    per class (8 classes, unused ones zero)."""
    B, Di, Hi, Wi, Cin = x5_shape
    _, Do, Ho, Wo, Cout = out5_shape
    head = [B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, 8 * p.nt, *strides, *ostrides, *p.tile,
            *p.box, p.stream, int(relu), len(classes), p.smem_bytes, p.w_smem_off,
            p.zero_off, p.toff_off, p.kpad, p.grid_x, k5_shape[1], k5_shape[2],
            p.box_bytes, sum(math.prod(t) for t in p.tiles), p.nbuf, int(p.persist), p.nch]
    head += [0] * (40 - len(head))
    body = []
    first = 0
    for c, t in zip(classes, p.tiles):
        body += [*c.taps, *c.pads, *c.grid, *c.offset, *c.start, *t, first, 0]
        first += math.prod(t)
    body += [0] * (20 * (MAX_CLASSES - len(classes)))
    return np.asarray(head + body, dtype=np.int32)


@functools.lru_cache(maxsize=256)
def _prepared(x5_shape, out5_shape, k5_shape, strides, ostrides, classes, relu: bool):
    """(plan, plan ints) of one call shape: the tile search and the int
    table run once per shape, not once per call."""
    p = plan(x5_shape[-1], out5_shape[-1], strides, classes, x5_shape[0])
    return p, plan_ints(p, x5_shape, out5_shape, k5_shape, strides, ostrides, classes, relu)


def launch(lib: str, x5, kernel5, bias, out5, strides, ostrides, classes, relu: bool):
    """One launch of `<lib>_tc_launch` on x5 (B, Di, Hi, Wi, Cin) bf16 into
    out5 (B, Do, Ho, Wo, Cout); kernel5 (KD, KH, KW, Cin, Cout) contiguous
    in x's dtype (each class reads its slice [start::ostride] from it), bias
    float32 or None."""
    p, ints = _prepared(tuple(x5.shape), tuple(out5.shape), tuple(kernel5.shape),
                        tuple(strides), tuple(ostrides), tuple(classes), bool(relu))
    fn = _lib.launcher(lib, _ARGTYPES, entry="tc_launch")
    err = fn(p.nt, p.mt, p.warps, ints.ctypes.data_as(ctypes.c_void_p), _lib.ptr(x5),
             _lib.ptr(kernel5), None if bias is None else _lib.ptr(bias), _lib.ptr(out5),
             _lib.stream_of(x5))
    _lib.check(lib, err)


def deconv_by_classes(x, kernel, bias=None, relu: bool = False, lo=0, out_spatial=None):
    """A stride-2 transposed conv computed class by class with plain PyTorch
    (each class a stride-1 conv of x with its kernel slice, scattered to
    its output parity), float32 on x's values; the same function as
    `deconv.deconv_plain`."""
    from mvsnet_tpu_torch.ops.kernels.deconv import _check_args

    rank, k, los, outs = _check_args(x, kernel, bias, lo, out_spatial)
    x5 = x[:, None] if rank == 2 else x
    k5 = kernel[None] if rank == 2 else kernel
    ins = x5.shape[1:-1]
    los3 = (0, *los) if rank == 2 else los
    outs3 = (1, *outs) if rank == 2 else outs
    classes = deconv_classes(k, ins, los3, outs3, (rank == 3, True, True))
    xf = x5.to(torch.float32).movedim(-1, 1)                       # (B, Cin, D, H, W)
    w = k5.to(x.dtype).to(torch.float32)
    y = xf.new_zeros((x5.shape[0], kernel.shape[-1], *outs3))
    for c in classes:
        sl = tuple(slice(s, None, st) for s, st in zip(c.start, c.step))
        wc = w[sl].permute(4, 3, 0, 1, 2)                            # (Cout, Cin, taps..)
        # stride-1 conv over the class grid: pad lo, and hi so that exactly
        # grid outputs come out (negative pads crop)
        flat = []
        for n, t, p, g in reversed(list(zip(ins, c.taps, c.pads, c.grid))):
            flat += [p, g - 1 + t - n - p]
        yc = F.conv3d(F.pad(xf, flat), wc)
        y[(..., *(slice(o, None, st) for o, st in zip(c.offset, c.step)))] = yc
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1, 1, 1, 1)
    if relu:
        y = torch.relu(y)
    y = y.movedim(1, -1).to(x.dtype).contiguous()
    return y[:, 0] if rank == 2 else y
