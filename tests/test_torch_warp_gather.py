"""The transposed warp K3 (`csrc/warp.cu`, `warp_transpose_kernel`) as a
gather, held on the CPU through a numpy mirror of the kernel: its plan
(`ops/kernels/warp.transpose_plan`), each tile's box of reference pixels
(the corners of the tile's source box mapped through the inverse
homography, with a margin; the whole map on a flagged plane or where a
corner reaches the horizon), its fills of at most P pixels, the table of
taps projected with a copy of `common.cuh`'s float32 `project`, each
owner's window (the preimage of its tap cell, from the grid of source
points) and its sums in the kernel's fixed order.

The mirror's contributor count of every output pixel must equal the
scatter's exactly (integers: every (depth, reference pixel, tap) whose tap
lies in the map, from the same `project`), and its values must be within
1e-5 (absolute and relative; float32 sums of a handful of products in
another order) of `warp_transpose_plain` and of JAX's
`_pallas_warp_transpose` in interpret mode (mvsnet_tpu/ops/pallas/sweep.py:1701).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvsnet_tpu.ops.pallas.sweep import _pallas_warp_transpose
from mvsnet_tpu_torch.ops.kernels import warp

F32 = np.float32
# csrc/warp.cu: kRows, kCap, kStageBytes, kEps, kEpsRel
ROWS, CAP, STAGE_BYTES, EPS, EPS_REL = 8, 512, 96 * 1024, 0.05, 0.01
TIGHT = dict(atol=1e-5, rtol=1e-5)


def project(h, x, y, H, W):
    """common.cuh `project` in float32, step by step, on integer arrays x,
    y: (x0, y0, fx, fy), the top-left tap clamped to [-2, W] x [-2, H]."""
    h = h.astype(F32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        px, py = x.astype(F32) + F32(0.5), y.astype(F32) + F32(0.5)
        u = h[0, 0] * px + h[0, 1] * py + h[0, 2]
        q = h[1, 0] * px + h[1, 1] * py + h[1, 2]
        w = h[2, 0] * px + h[2, 1] * py + h[2, 2]
        w = np.where(np.abs(w) < F32(1e-7), np.where(w < 0, F32(-1e-7), F32(1e-7)), w)
        sx, sy = u / w - F32(0.5), q / w - F32(0.5)
        x0f, y0f = np.floor(sx), np.floor(sy)
        x0 = np.fmin(np.fmax(x0f, F32(-2)), F32(W)).astype(np.int64)
        y0 = np.fmin(np.fmax(y0f, F32(-2)), F32(H)).astype(np.int64)
        return x0, y0, (sx - x0f).astype(F32), (sy - y0f).astype(F32)


def preimage(inv, wsign, U, V):
    """warp.cu `preimage` in float32: (x, y), or None."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        X = inv[0, 0] * U + inv[0, 1] * V + inv[0, 2]
        Y = inv[1, 0] * U + inv[1, 1] * V + inv[1, 2]
        Z = inv[2, 0] * U + inv[2, 1] * V + inv[2, 2]
        zmag = abs(inv[2, 0] * U) + abs(inv[2, 1] * V) + abs(inv[2, 2])
        if not F32(wsign) * Z > F32(1e-4) * zmag:
            return None
        rz = F32(1) / Z
        x, y = X * rz - F32(0.5), Y * rz - F32(0.5)
    return (x, y) if np.isfinite(x) and np.isfinite(y) else None


def span(a, b, n):
    """warp.cu `span`: the integers within the margin of [a, b] in [0, n)."""
    e = F32(EPS) + F32(EPS_REL) * (b - a)
    return (max(0, int(np.ceil(max(a - e, F32(-8))))),
            min(n - 1, int(np.floor(min(b + e, F32(n + 8))))))


def source_point(u0, v0, i, j):
    """Grid point (i, j) of the tile at (u0, v0): (u0 + i - 0.5, v0 + j - 0.5)."""
    return F32(u0 + i) - F32(0.5), F32(v0 + j) - F32(0.5)


def tile_box(inv, wsign, u0, v0, TX, H, W):
    """warp.cu `tile_box`: (x0, y0, x1, y1), inclusive."""
    whole = (0, 0, W - 1, H - 1)
    if wsign == 0:
        return whole
    pts = [preimage(inv, wsign, *source_point(u0, v0, i, j))
           for j in (0, ROWS + 1) for i in (0, TX + 1)]
    if any(p is None for p in pts):
        return whole
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    (x0, x1), (y0, y1) = span(min(xs), max(xs), W), span(min(ys), max(ys), H)
    return x0, y0, x1, y1


def window(inv, wsign, u0, v0, a, b, H, W):
    """An owner's window (x0, x1, y0, y1) from the grid points (a, b) to
    (a + 2, b + 2), as the kernel reads them; the whole map where one is
    not finite."""
    pts = [preimage(inv, wsign, *source_point(u0, v0, i, j)) if wsign else None
           for j in (b, b + 2) for i in (a, a + 2)]
    if any(p is None for p in pts):
        return 0, W - 1, 0, H - 1
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    return (*span(min(xs), max(xs), W), *span(min(ys), max(ys), H))


def fills(inv, wsign, u0, v0, TX, D, H, W, P):
    """warp.cu `next_fill`'s walk: (d, x0, y0, nr, fw) of each fill, rows
    [y0, y0 + nr) and columns [x0, x0 + fw) of the map."""
    for d in range(D):
        bx0, by0, bx1, by1 = tile_box(inv[d], int(wsign[d]), u0, v0, TX, H, W)
        if bx1 < bx0 or by1 < by0:
            continue
        bw, bh = bx1 - bx0 + 1, by1 - by0 + 1
        r0 = 0
        while r0 < bh:
            nr = min(P // min(P, bw), bh - r0)
            for c0 in range(0, bw, P):
                yield d, bx0 + c0, by0 + r0, nr, min(P, bw - c0)
            r0 += nr


def gather(g, homs, C, P=None):
    """The kernel's walk, block by block: (out (H, W, C) float32, the
    contributor count of each output pixel). P: pixels a fill holds (the
    kernel's, for float32 cotangents, by default)."""
    D, H, W, _ = g.shape
    inv, wsign = (t.numpy() for t in warp.transpose_plan(torch.from_numpy(homs), H, W))
    assert warp.TILE_ROWS == ROWS
    TX = 32 // (C // warp.lane_channels(C))
    assert warp.transpose_tiles(H, W, C) == (-(-H // ROWS), -(-W // TX))
    P = P or min(CAP, STAGE_BYTES // (2 * 16 * (C * 4 // 16)))
    out = np.full((H, W, C), np.nan, F32)        # the kernel writes every element
    counts = np.zeros((H, W), np.int64)
    for v0 in range(0, H, ROWS):
        for u0 in range(0, W, TX):
            acc = np.zeros((ROWS, TX, C), F32)
            for d, x0, y0, nr, fw in fills(inv, wsign, u0, v0, TX, D, H, W, P):
                assert nr * fw <= P
                yy, xx = np.meshgrid(np.arange(y0, y0 + nr), np.arange(x0, x0 + fw),
                                     indexing="ij")
                tx0, ty0, fx, fy = project(homs[d], xx, yy, H, W)
                cx, cy = tx0 - u0, ty0 - v0
                staged = g[d, y0:y0 + nr, x0:x0 + fw]
                for b in range(min(ROWS, H - v0)):          # the owners
                    for a in range(min(TX, W - u0)):
                        wx0, wx1, wy0, wy1 = window(inv[d], int(wsign[d]), u0, v0, a, b, H, W)
                        for r in range(max(wy0, y0) - y0, min(wy1, y0 + nr - 1) - y0 + 1):
                            for c in range(max(wx0, x0) - x0, min(wx1, x0 + fw - 1) - x0 + 1):
                                dx, dy = a - cx[r, c], b - cy[r, c]
                                if dx not in (0, 1) or dy not in (0, 1):
                                    continue
                                wgt = ((fy[r, c] if dy else F32(1) - fy[r, c])
                                       * (fx[r, c] if dx else F32(1) - fx[r, c]))
                                acc[b, a] += F32(wgt) * staged[r, c]
                                counts[v0 + b, u0 + a] += 1
            hb, wb = min(ROWS, H - v0), min(TX, W - u0)
            out[v0:v0 + hb, u0:u0 + wb] = acc[:hb, :wb]
    return out, counts


def scatter_counts(homs, H, W):
    """Contributions the scatter makes into each pixel: every (depth,
    reference pixel, tap) whose tap lies inside the map."""
    counts = np.zeros((H, W), np.int64)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for h in homs:
        x0, y0, _, _ = project(h, xx, yy, H, W)
        for dy in (0, 1):
            for dx in (0, 1):
                ty, tx = y0 + dy, x0 + dx
                inside = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
                np.add.at(counts, (ty[inside], tx[inside]), 1)
    return counts


def _homs(D, scale=1.0, rot=0.02, shift=6.0):
    """tests/test_torch_grad_kernels.py `_homs`: shifts, a rotation, a
    slight tilt."""
    c, s = np.cos(rot), np.sin(rot)
    h = np.zeros((D, 3, 3), np.float32)
    for d in range(D):
        t = d / max(D - 1, 1) - 0.5
        h[d] = [[scale * c, -s, shift * t], [s, scale * c, 0.4 * t], [1e-4, -5e-5, 1.0]]
    return h


def _special(D=5):
    """Planes the bounds must survive: an ordinary one, one whose every tap
    falls outside the map, one whose horizon (w = 0 at x + 0.5 = 10)
    crosses the map, one with w = -1 everywhere (the identity, negated), and
    a strongly tilted one whose horizon lies just off the map's right edge."""
    h = _homs(D, 1.1, 0.1, 8.0)
    h[1, :2, 2] = [1000.0, -700.0]
    h[2] = [[1.0, 0.05, 0.0], [0.0, 1.0, 0.0], [0.1, 0.0, -1.0]]
    h[3] = -np.eye(3, dtype=np.float32)
    h[4] = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-0.035, 0.0, 1.0]]
    return h


HOMS = {
    "scale0.5": lambda: _homs(5, 0.5, 0.02, 6.0),
    "scale1": lambda: _homs(5, 1.0, 0.02, 6.0),
    "scale2": lambda: _homs(5, 2.0, 0.02, 6.0),
    "rot0.3_off_every_edge": lambda: _homs(5, 1.0, 0.3, 20.0),
    "outside_horizon_negative": _special,
}


@pytest.mark.parametrize("C,W", [(8, 24), (16, 40), (32, 40), (64, 24)])
@pytest.mark.parametrize("which", sorted(HOMS))
def test_gather_mirror_matches_scatter(which, C, W):
    """Tiles of 32 pixels (C = 8, 16, 32) and of 16 (C = 64: two lanes a
    pixel), one or two across the map."""
    H = 16
    homs = HOMS[which]()
    g = np.random.default_rng(3).standard_normal((len(homs), H, W, C)).astype(F32)
    out, counts = gather(g, homs, C)
    np.testing.assert_array_equal(counts, scatter_counts(homs, H, W))
    plain = warp.warp_transpose(torch.from_numpy(g), torch.from_numpy(homs)).numpy()
    np.testing.assert_allclose(out, plain, **TIGHT)
    pallas = _pallas_warp_transpose(jnp.asarray(g), jnp.asarray(homs), H, W, C, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TIGHT)


@pytest.mark.parametrize("P", [16, 5])
def test_gather_mirror_in_small_fills(P):
    """Fills of P pixels, as the kernel cuts them at wide C (P = 32 at C =
    256 in float32): boxes wider than P, the whole-map route included, go
    in column chunks and several row chunks, and the counts stay the
    scatter's."""
    H, W, C = 16, 24, 16
    homs = _special()
    g = np.random.default_rng(4).standard_normal((len(homs), H, W, C)).astype(F32)
    out, counts = gather(g, homs, C, P)
    np.testing.assert_array_equal(counts, scatter_counts(homs, H, W))
    plain = warp.warp_transpose(torch.from_numpy(g), torch.from_numpy(homs)).numpy()
    np.testing.assert_allclose(out, plain, **TIGHT)


def test_mirror_takes_the_bounded_route():
    """On ordinary planes every tile's box is a little more than its source
    box (the gather does not degrade into a scan of the map), every owner's
    window a few pixels, and both hold the reference pixels that feed them;
    the tiles of a plane whose every tap falls outside get empty boxes."""
    H, W, C = 16, 24, 16
    homs = _homs(5, 1.0, 0.02, 6.0)
    inv, wsign = (t.numpy() for t in warp.transpose_plan(torch.from_numpy(homs), H, W))
    assert (wsign == 1).all()
    TX = 32 // (C // warp.lane_channels(C))
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for d in range(5):
        tx, ty, _, _ = project(homs[d], xx, yy, H, W)
        for v0 in range(0, H, ROWS):
            for u0 in range(0, W, TX):
                x0, y0, x1, y1 = tile_box(inv[d], 1, u0, v0, TX, H, W)
                assert x1 - x0 + 1 <= TX + 4 and y1 - y0 + 1 <= ROWS + 4
                feeds = (tx >= u0 - 1) & (tx < u0 + TX) & (ty >= v0 - 1) & (ty < v0 + ROWS)
                ys, xs = np.nonzero(feeds)
                assert (xs >= x0).all() and (xs <= x1).all()
                assert (ys >= y0).all() and (ys <= y1).all()
                for b in range(ROWS):
                    for a in range(TX):
                        if u0 + a >= W:
                            continue
                        wx0, wx1, wy0, wy1 = window(inv[d], 1, u0, v0, a, b, H, W)
                        assert wx1 - wx0 <= 3 and wy1 - wy0 <= 3
                        mine = ((tx == u0 + a) | (tx == u0 + a - 1)) & (
                            (ty == v0 + b) | (ty == v0 + b - 1))
                        ys, xs = np.nonzero(mine)
                        assert (xs >= wx0).all() and (xs <= wx1).all()
                        assert (ys >= wy0).all() and (ys <= wy1).all()
    far = _special()[1]
    inv, wsign = (t.numpy() for t in warp.transpose_plan(torch.from_numpy(far[None]), H, W))
    boxes = [tile_box(inv[0], int(wsign[0]), u0, v0, TX, H, W)
             for v0 in range(0, H, ROWS) for u0 in range(0, W, TX)]
    assert all(b[2] < b[0] or b[3] < b[1] for b in boxes)


@pytest.mark.parametrize("row2,want", [
    ([0.0, 0.0, 1.0], 1),
    ([1e-4, -5e-5, 1.0], 1),
    ([0.0, 0.0, -2.0], -1),
    ([0.1, 0.0, -1.0], 0),           # w = 0 at x + 0.5 = 10: the horizon crosses the map
    ([0.0, 0.0, 5e-8], 0),           # |w| < 1e-7 everywhere: projections pushed
    ([-(1 - 1e-6) / 23.5, 0.0, 1.0], 0),   # w = 1e-6 at the right edge: within the margin
    ([-(1 - 1e-4) / 23.5, 0.0, 1.0], 1),   # w = 1e-4 there: clear of it
])
def test_transpose_plan_flags(row2, want):
    H, W = 16, 24
    h = np.eye(3, dtype=np.float32)
    h[2] = row2
    h[0, 2] = 3.0
    inv, wsign = warp.transpose_plan(torch.from_numpy(h[None]), H, W)
    assert wsign.dtype == torch.int32 and inv.dtype == torch.float32
    assert wsign.tolist() == [want]
    if want != 0:
        np.testing.assert_allclose(inv[0].numpy() @ h, np.eye(3), atol=1e-6)


def test_transpose_plan_flags_a_singular_homography():
    h = np.array([[[1.0, 0, 0], [0, 0, 0], [0, 0, 1]]], np.float32)
    _, wsign = warp.transpose_plan(torch.from_numpy(h), 8, 8)
    assert wsign.tolist() == [0]


def test_transpose_plan_of_the_special_planes():
    _, wsign = warp.transpose_plan(torch.from_numpy(_special()), 16, 24)
    assert wsign.tolist() == [1, 1, 0, -1, 1]


@pytest.mark.parametrize("C,cpl,tiles,segments", [
    (32, 32, (15, 5), 3),     # the training point: 75 tiles of 8 x 32 pixels
    (16, 16, (15, 5), 3),
    (8, 8, (15, 5), 3),
    (64, 32, (15, 10), 1),
    (24, 8, (15, 16), 1),
])
def test_transpose_tiles_and_segments(C, cpl, tiles, segments):
    """K3's lane channels, tiles and depth runs at 120 x 160, D=192, on a
    card of 132 SMs (two blocks an SM): enough runs for one wave."""
    assert warp.lane_channels(C) == cpl
    assert warp.transpose_tiles(120, 160, C) == tiles
    assert warp.transpose_segments(192, 120, 160, C, 132) == segments
    assert warp.transpose_segments(2, 8, 8, C, 132) == 2      # at most D
