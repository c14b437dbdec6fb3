"""The parts of the redesigned K4w and K1 that the CPU reaches.

K4w, tensor-core edition (`csrc/wgrad.cu` `wgrad_tc_kernel`): a numpy
mirror of the kernel's indexing, fed the plan ints the wrapper passes,
walks each block's tiles, stages each tile's zero-filled input box and
cotangent tile into a simulated shared memory (XOR-swizzled 16-byte chunks,
a stride-2 box's even columns first, every other chunk NaN so that a read
of a chunk nothing staged shows), gathers every ldmatrix.trans fragment
from the lanes' addresses, multiplies them as mma.sync.m16n8k16 does,
writes each (block, warp group) partial where the kernel does and adds the
partials in the second pass's order. It must equal `wgrad_plain` on 3D s1
and s2, 2D 3x3 s1/s2 and 5x5 s2, the transposed conv's swapped roles, and
a Cout of 1 zero-padded to 8 columns, and plans that split row tiles, Cout
slices and k steps; one case also against
JAX's Pallas weight gradient in interpret mode. Then the edition rule and
the plan table against the kernel's struct.

K1 (`csrc/cost_volume.cu`): a numpy mirror of the new tile and depth walk
(one block a tile of 8 rows by 32 / (C / 8) pixels and a run of depths, a
table of taps per chunk of depths, the views in order, the means by 1 / V)
with a row offset, against `cost_volume_plain`.

Tolerances: float32 (the mirrors) against float32 with sums in another
order: 1e-4 absolute and relative for the weight gradients (hundreds of
products a sum, as tests/test_torch_grad_kernels.py), 1e-5 for the cost
volume (a handful of terms).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvsnet_tpu.ops.pallas.conv3d import _pallas_wgrad_s1, _pallas_wgrad_s2
from mvsnet_tpu_torch.ops.kernels import conv, sweep, wgrad

SUMS = dict(atol=1e-4, rtol=1e-4)
CSRC = Path(wgrad.__file__).resolve().parents[2] / "csrc"


def _struct_fields(src, name):
    """Field names of `struct <name> { int a, b; int c[2]; ... }`, arrays
    expanded, comments removed."""
    body = src[src.index(f"struct {name} {{"):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:body.index("};")])
    names = []
    for decl in re.findall(r"\bint\s+([^;]+);", body):
        for item in decl.split(","):
            item = item.strip()
            size = re.search(r"\[(\w+)\]", item)
            names += ([f"{item[:item.index('[')]}{i}" for i in range(int(size.group(1)))]
                      if size else [item])
    return names


FIELDS = _struct_fields((CSRC / "wgrad.cu").read_text(), "TcPlan")


def _swizzle(nch):
    """csrc/tc_conv.cuh `Swizzle`: chunk slot of (pixel, chunk)."""
    shift = mask = 0
    if nch & (nch - 1) == 0:
        if nch >= 8:
            mask = 7
        elif nch > 1:
            mask, shift = nch - 1, (1 if nch == 4 else 2)
    return lambda pix, c: pix * nch + (c ^ ((pix >> shift) & mask))


def _operands(x, g, ksize, stride):
    """The wrapper's 5D views, taps, strides and low pads."""
    los = [conv.same_pads(n, k, stride)[0] for n, k in zip(x.shape[1:-1], ksize)]
    if x.ndim == 4:
        return x[:, None], g[:, None], (1, *ksize), (1, stride, stride), (0, *los)
    return x, g, tuple(ksize), (stride,) * 3, tuple(los)


def mirror_tc(x, g, ksize, stride, plan=None):
    """dk as csrc/wgrad.cu's tensor-core edition computes it, from the plan
    ints alone (float64 products of the float32 inputs). A Cin % 8 != 0
    is gathered element by element, padded per tap, and the second pass
    maps dk's rows to the workspace's padded rows."""
    x5, g5, taps, strides, los = _operands(x, g, ksize, stride)
    if plan is None:
        plan = wgrad.tc_plan(x5.shape, g5.shape, taps, strides, los)
    P = dict(zip(FIELDS, wgrad.plan_ints(plan, x5.shape, g5.shape, taps, strides, los).tolist()))
    nt, mt_n = plan.nt, plan.mt
    Cin, Cout = P["Cin"], P["Cout"]
    nch, gch = P["nch"], -(-Cout // 8)
    swx, swg = _swizzle(nch), _swizzle(nt)
    half_x = (P["BX"] + 1) >> 1
    xflat = x5.astype(np.float64).reshape(*x5.shape[:3], -1)

    def xpos(bx):
        return (bx & 1) * half_x + (bx >> 1) if P["sw"] == 2 else bx

    M = P["TZ"] * P["TY"] * P["TX"]
    box_chunks, g_chunks = P["box_bytes"] // 16, P["g_bytes"] // 16
    xf, gf = x5.astype(np.float64), g5.astype(np.float64)
    rows = P["units"] * 8
    ws = np.full((P["grid_x"] * P["kg"], rows, Cout), np.nan)

    def stage(t, smem, base):
        per_b = P["tz"] * P["ty"] * P["tx"]
        b, t = divmod(t, per_b)
        iz, t = divmod(t, P["ty"] * P["tx"])
        iy, ix = divmod(t, P["tx"])
        oz, oy, ox = iz * P["TZ"], iy * P["TY"], ix * P["TX"]
        iz0, iy0, ix0 = oz * P["sd"] - P["pd"], oy * P["sh"] - P["ph"], ox * P["sw"] - P["pw"]
        for q in range(P["BZ"] * P["BY"] * P["BX"] * nch):
            pix, c = divmod(q, nch)
            r, bx = divmod(pix, P["BX"])
            bz, by = divmod(r, P["BY"])
            zz, yy, xx = iz0 + bz, iy0 + by, ix0 + bx
            slot = base + swx(pix - bx + xpos(bx), c)
            if Cin % 8 == 0:
                inside = 0 <= zz < P["Di"] and 0 <= yy < P["Hi"] and 0 <= xx < P["Wi"]
                smem[slot] = xf[b, zz, yy, xx, 8 * c:8 * c + 8] if inside else 0.0
                continue
            # the element-by-element gather from the channels-last row
            inside = 0 <= zz < P["Di"] and 0 <= yy < P["Hi"]
            f0 = (ix0 + bx) * Cin + 8 * c
            smem[slot] = [xflat[b, zz, yy, f0 + i]
                          if inside and 8 * c + i < Cin and 0 <= f0 + i < P["Wi"] * Cin else 0.0
                          for i in range(8)]
        gbase = base + box_chunks
        for q in range(M * nt):
            v, c = divmod(q, nt)
            rr, lx = divmod(v, P["TX"])
            lz, ly = divmod(rr, P["TY"])
            zz, yy, xx, ch = oz + lz, oy + ly, ox + lx, gc0 + c
            inside = zz < P["Do"] and yy < P["Ho"] and xx < P["Wo"] and ch < gch
            chunk = np.zeros(8)            # a Cout under 8 is zero-padded to the chunk
            if inside:
                vals = gf[b, zz, yy, xx, 8 * ch:8 * ch + 8]
                chunk[:len(vals)] = vals
            smem[gbase + swg(v, c)] = chunk

    for by_ in range(P["grid_y"]):
        ms, ns = by_ % P["m_slices"], by_ // P["m_slices"]
        gc0 = ns * nt
        for bx_ in range(P["grid_x"]):
            smem = np.full((2 * (box_chunks + g_chunks), 8), np.nan)
            acc = np.zeros((8, mt_n, nt, 16, 8))        # warp, row tile, column tile
            for T in range(bx_, P["n_tiles"], P["grid_x"]):
                buf = ((T - bx_) // P["grid_x"]) % 2
                base = buf * (box_chunks + g_chunks)
                smem[base:base + box_chunks + g_chunks] = np.nan
                stage(T, smem, base)
                for warp in range(8):
                    wm, kg = warp % P["wm"], warp // P["wm"]
                    j0 = (ms * P["wm"] + wm) * mt_n
                    nvalid = min(mt_n, P["m_tiles"] - j0)
                    for kk in range(kg, P["ksteps"], P["kg"]):
                        # B: lane l gives voxel 16 kk + (l & 7) + 8 ((l >> 3) & 1)
                        # and chunk 2p + (l >> 4); matrix i of an x4 = lanes 8i..
                        bmat = np.zeros((nt, 16, 8))
                        for lane in range(32 if nt > 1 else 16):
                            vb = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)
                            for p in range(max(1, nt // 2)):
                                c = 2 * p + (lane >> 4) if nt > 1 else 0
                                val = smem[base + box_chunks + swg(vb, c)]
                                i, r = lane >> 3, lane & 7
                                col_tile = 2 * p + (i >> 1) if nt > 1 else 0
                                bmat[col_tile, 8 * (i & 1) + r, :] = val
                        # A: lane l gives voxel 16 kk + (l & 7) + 8 (l >> 4), unit 2j + ((l >> 3) & 1)
                        for mt in range(max(0, nvalid)):
                            amat = np.zeros((16, 16))       # m x k
                            for lane in range(32):
                                half = (lane >> 3) & 1
                                u = 2 * (j0 + mt) + half
                                if u >= P["units"]:
                                    u = 0
                                tap, c = divmod(u, nch)
                                a, rem = divmod(tap, P["KH"] * P["KW"])
                                bb, e = divmod(rem, P["KW"])
                                uoff = (a * P["BY"] + bb) * P["BX"] + xpos(e)
                                va = 16 * kk + (lane & 7) + ((lane >> 4) << 3)
                                rr, lx = divmod(va, P["TX"])
                                lz, ly = divmod(rr, P["TY"])
                                rp = (lz * P["sd"] * P["BY"] + ly * P["sh"]) * P["BX"] + lx
                                val = smem[base + swx(rp + uoff, c)]
                                i, r = lane >> 3, lane & 7
                                # .trans: stored row r (a voxel) is column k
                                amat[8 * (i & 1):8 * (i & 1) + 8, 8 * (i >> 1) + r] = val
                            for n in range(nt):
                                acc[warp, mt, n] += amat @ bmat[n]
            for warp in range(8):
                wm, kg = warp % P["wm"], warp // P["wm"]
                j0 = (ms * P["wm"] + wm) * mt_n
                for mt in range(max(0, min(mt_n, P["m_tiles"] - j0))):
                    for n in range(nt):
                        for rr_ in range(16):
                            row = 16 * (j0 + mt) + rr_
                            col = (gc0 + n) * 8
                            if row < rows and col < Cout:
                                cols = min(8, Cout - col)
                                ws[bx_ * P["kg"] + kg, row, col:col + cols] = \
                                    acc[warp, mt, n, rr_, :cols]
    assert not np.isnan(ws).any(), "a partial the kernel leaves unwritten, or a NaN chunk read"
    # the second pass: dk's row r from padded row (r / Cin) * nch * 8 +
    # r % Cin, the partials added in order
    src = [(r // Cin) * nch * 8 + r % Cin for r in range(math.prod(taps) * Cin)]
    out = ws[0, src].copy()
    for k in range(1, ws.shape[0]):
        out += ws[k, src]
    return out.reshape(*taps, Cin, Cout)[0 if x.ndim == 4 else slice(None)]


def _case(seed, x_shape, cout, k, stride):
    rng = np.random.default_rng(seed)
    rank = len(x_shape) - 2
    x = rng.standard_normal(x_shape).astype(np.float32)
    outs = [conv.same_pads(n, k, stride)[2] for n in x_shape[1:-1]]
    g = rng.standard_normal((x_shape[0], *outs, cout)).astype(np.float32)
    return x, g, (k,) * rank


def _plain(x, g, ksize, stride):
    return wgrad.wgrad_plain(torch.from_numpy(x), torch.from_numpy(g), ksize, stride).numpy()


def _pick(x, g, ksize, stride, **want):
    """The cheapest candidate plan with the asked-for properties."""
    x5, g5, taps, strides, los = _operands(x, g, ksize, stride)
    best = None
    for key, p in wgrad.tc_candidates(x5.shape, g5.shape, taps, strides, los):
        if all((getattr(p, k) > 1 if v == ">1" else getattr(p, k) == v) for k, v in want.items()):
            if best is None or key < best[0]:
                best = (key, p)
    assert best is not None, want
    return best[1]


@pytest.mark.parametrize("x_shape,cout,k,stride", [
    ((1, 4, 5, 16, 32), 8, 3, 1),          # 3D s1 (3dconv0_1's channels)
    ((1, 5, 7, 17, 32), 16, 3, 2),         # 3D s2, odd sizes (3dconv1_0)
    ((1, 6, 8, 16, 8), 16, 3, 2),          # the deconv dk: x' 8 ch full res, g' 16 ch
    ((1, 4, 5, 16, 8), 1, 3, 1),           # Cout = 1, zero-padded to 8 (3dconv6_2)
    ((2, 9, 20, 8), 8, 3, 1),              # 2D 3x3 s1 (2dconv0_2)
    ((2, 9, 19, 16), 32, 3, 2),            # 2D 3x3 s2
    ((2, 11, 21, 8), 16, 5, 2),            # 2D 5x5 s2 (conv9_0)
    ((1, 4, 6, 128), 128, 3, 1),           # 128 x 128: row tiles and Cout slices split
])
def test_tc_mirror_matches_plain(x_shape, cout, k, stride):
    x, g, ks = _case(len(x_shape) * 10 + k + stride, x_shape, cout, k, stride)
    np.testing.assert_allclose(mirror_tc(x, g, ks, stride), _plain(x, g, ks, stride), **SUMS)


@pytest.mark.parametrize("want", [dict(kg=">1"), dict(m_slices=">1"), dict(n_slices=">1")])
def test_tc_mirror_splits_match_plain(want):
    """Plans that take every kg-th k step per warp group, or split row
    tiles or Cout slices over blockIdx.y."""
    x, g, ks = _case(7, (1, 3, 5, 8, 32), 32, 3, 1)
    plan = _pick(x, g, ks, 1, **want)
    np.testing.assert_allclose(mirror_tc(x, g, ks, 1, plan), _plain(x, g, ks, 1), **SUMS)


def test_tc_mirror_matches_pallas_interpret():
    """The deconv dk's geometry at stride 2 against JAX's Pallas weight
    gradient in interpret mode (its (B, D, H, C, W) layout)."""
    x, g, ks = _case(11, (1, 4, 6, 16, 8), 16, 3, 2)
    want = np.asarray(_pallas_wgrad_s2(jnp.swapaxes(jnp.asarray(x), -1, -2),
                                       jnp.swapaxes(jnp.asarray(g), -1, -2), interpret=True))
    np.testing.assert_allclose(mirror_tc(x, g, ks, 2), want, **SUMS)
    x, g, ks = _case(12, (1, 3, 4, 16, 16), 8, 3, 1)
    want = np.asarray(_pallas_wgrad_s1(jnp.swapaxes(jnp.asarray(x), -1, -2),
                                       jnp.swapaxes(jnp.asarray(g), -1, -2), interpret=True))
    np.testing.assert_allclose(mirror_tc(x, g, ks, 1), want, **SUMS)


@pytest.mark.parametrize("dtype,cin,cout,want", [
    (torch.bfloat16, 32, 8, "tc"), (torch.bfloat16, 8, 16, "tc"),
    (torch.bfloat16, 128, 128, "tc"), (torch.bfloat16, 3, 8, "tc"),
    (torch.bfloat16, 8, 1, "tc"), (torch.float32, 32, 8, "simt"),
    (torch.bfloat16, 1, 1, "tc"), (torch.bfloat16, 5, 8, "tc"), (torch.bfloat16, 10, 4, "tc"),
    (torch.float32, 3, 8, "simt"),
])
def test_wgrad_edition_rule(dtype, cin, cout, want):
    assert wgrad.pick_edition(dtype, cin, cout) == want
    assert wgrad.pick_edition(dtype, cin, cout, "simt") == "simt"
    if want == "tc":
        assert wgrad.pick_edition(dtype, cin, cout, "tc") == "tc"
    else:
        with pytest.raises(ValueError, match="tensor-core"):
            wgrad.pick_edition(dtype, cin, cout, "tc")


def test_wgrad_edition_request_is_checked_on_cpu():
    """"tc" on float32 or an unknown edition raises on the CPU too; a bf16
    "tc" request runs the plain version there and counts no launch."""
    x, g = torch.zeros(1, 6, 6, 8), torch.zeros(1, 6, 6, 8)
    with pytest.raises(ValueError, match="tensor-core"):
        wgrad.wgrad(x, g, (3, 3), 1, edition="tc")
    with pytest.raises(ValueError, match="edition"):
        wgrad.wgrad(x, g, (3, 3), 1, edition="wgmma")
    before = (wgrad.launches, dict(wgrad.launches_by_edition))
    out = wgrad.wgrad(x.bfloat16(), g.bfloat16(), (3, 3), 1, edition="tc")
    assert out.shape == (3, 3, 8, 8) and out.dtype == torch.float32
    assert (wgrad.launches, wgrad.launches_by_edition) == before


def test_tc_plan_ints_match_the_kernel_struct():
    """`plan_ints` fills the 40 ints of csrc/wgrad.cu's `TcPlan` (whose
    static_assert holds only on the card), in its field order."""
    assert len(FIELDS) == 40
    x, g, ks = _case(1, (1, 4, 5, 16, 32), 8, 3, 1)
    x5, g5, taps, strides, los = _operands(x, g, ks, 1)
    p = wgrad.tc_plan(x5.shape, g5.shape, taps, strides, los)
    ints = wgrad.plan_ints(p, x5.shape, g5.shape, taps, strides, los)
    assert ints.shape == (40,) and ints.dtype == np.int32
    P = dict(zip(FIELDS, ints.tolist()))
    assert (P["TZ"], P["TY"], P["TX"]) == p.tile and (P["BZ"], P["BY"], P["BX"]) == p.box
    assert P["kg"] * P["wm"] == wgrad.TC_WARPS and P["ksteps"] * 16 == math.prod(p.tile)
    assert P["units"] == 27 * 4 and P["m_tiles"] == 54 and P["grid_x"] == p.grid_x
    assert P["nch"] == 4


@pytest.mark.parametrize("x_shape,cout,k,stride", [
    ((1, 9, 16, 1), 1, 3, 1),              # prob_conv 1x1
    ((1, 9, 16, 2), 3, 3, 1),              # the GRU input gradients' 2 channels
    ((1, 9, 16, 3), 8, 3, 1),              # the images' 3 channels
    ((1, 9, 17, 5), 8, 3, 1),              # 2dconv0_1_refine 5x8
    ((1, 8, 16, 10), 4, 3, 1),             # gru2 10x4
    ((1, 4, 5, 16, 1), 8, 3, 1),           # 3D, Cin 1
    ((2, 9, 19, 3), 16, 3, 2),             # 2D 3x3 s2 (2dconv1_0)
    ((1, 11, 21, 5), 8, 5, 2),             # 2D 5x5 s2
])
def test_tc_mirror_small_cin_matches_plain(x_shape, cout, k, stride):
    """Cin % 8 != 0, padded per tap: the mirror of the kernel's gathers,
    fragments and second pass equals `wgrad_plain`."""
    x, g, ks = _case(sum(x_shape) + k, x_shape, cout, k, stride)
    np.testing.assert_allclose(mirror_tc(x, g, ks, stride), _plain(x, g, ks, stride), **SUMS)


@pytest.mark.parametrize("cin,nch", [(1, 1), (3, 1), (5, 1), (10, 2), (20, 3)])
def test_tc_small_cin_workspace_holds_the_padded_rows(cin, nch):
    """The plan's units count the padded layout's rows, taps x ceil(Cin /
    8), and its box the padded chunks."""
    x5, g5 = (1, 1, 20, 32, cin), (1, 1, 20, 32, 8)
    p = wgrad.tc_plan(x5, g5, (1, 3, 3), (1, 1, 1), (0, 1, 1))
    P = dict(zip(FIELDS, wgrad.plan_ints(p, x5, g5, (1, 3, 3), (1, 1, 1), (0, 1, 1))))
    assert P["nch"] == nch and P["units"] == wgrad.tc_units(p, (1, 3, 3)) == 9 * nch
    assert P["box_bytes"] >= math.prod(p.box) * nch * 16


# every tc weight gradient of a train step at 640x480, D=192 (x, g, k, stride)
TRAIN_LAYERS = [
    ((1, 192, 120, 160, 32), (1, 192, 120, 160, 8), 3, 1),
    ((1, 192, 120, 160, 32), (1, 96, 60, 80, 16), 3, 2),
    ((1, 192, 120, 160, 8), (1, 96, 60, 80, 16), 3, 2),
    ((1, 96, 60, 80, 16), (1, 48, 30, 40, 32), 3, 2),
    ((1, 24, 15, 20, 64), (1, 24, 15, 20, 64), 3, 1),
    ((3, 480, 640, 8), (3, 480, 640, 8), 3, 1),
    ((3, 480, 640, 8), (3, 240, 320, 16), 5, 2),
    ((3, 30, 40, 128), (3, 30, 40, 128), 3, 1),
    ((3, 30, 40, 64), (3, 15, 20, 128), 3, 2),
]


@pytest.mark.parametrize("x_shape,g_shape,k,stride", TRAIN_LAYERS)
def test_tc_plans_of_the_train_step_fit_the_card(x_shape, g_shape, k, stride):
    """Each plan's buffers fit a block's shared memory, its workspace the
    limit, its box and tile the exact range of FastDiv, and its row tiles
    and Cout slices cover dk."""
    x = np.zeros(x_shape, np.float32)
    g = np.zeros(g_shape, np.float32)
    x5, g5, taps, strides, los = _operands(x, g, (k,) * (len(x_shape) - 2), stride)
    p = wgrad.tc_plan(x5.shape, g5.shape, taps, strides, los)
    P = dict(zip(FIELDS, wgrad.plan_ints(p, x5.shape, g5.shape, taps, strides, los).tolist()))
    assert p.mt in wgrad.TC_TILES[p.nt]
    assert P["smem_bytes"] == 2 * (P["box_bytes"] + P["g_bytes"]) <= wgrad.SMEM_LIMIT
    assert P["box_bytes"] >= math.prod(p.box) * x5.shape[-1] * 2 and P["box_bytes"] % 128 == 0
    assert math.prod(p.box) * x5.shape[-1] // 8 < wgrad.FASTDIV_LIMIT
    assert P["m_slices"] * P["wm"] * p.mt >= P["m_tiles"]
    assert p.n_slices * p.nt * 8 >= g5.shape[-1] and P["TX"] % 8 == 0
    assert P["grid_x"] * P["kg"] * P["units"] * 8 * g5.shape[-1] * 4 <= wgrad.WS_LIMIT
    assert 1 <= P["grid_x"] <= P["n_tiles"]


# ---- K1: the tile and depth walk

def _project(h, x, y, H, W):
    """csrc/common.cuh `project` in float32: (x0, y0, fx, fy) of pixel
    arrays x, y."""
    f = np.float32
    px, py = x.astype(f) + f(0.5), y.astype(f) + f(0.5)
    u = h[0] * px + h[1] * py + h[2]
    q = h[3] * px + h[4] * py + h[5]
    w = h[6] * px + h[7] * py + h[8]
    w = np.where(np.abs(w) < f(1e-7), np.where(w < 0, f(-1e-7), f(1e-7)), w)
    sx, sy = u / w - f(0.5), q / w - f(0.5)
    x0f, y0f = np.floor(sx), np.floor(sy)
    x0 = np.minimum(np.maximum(x0f, f(-2)), f(W)).astype(np.int64)
    y0 = np.minimum(np.maximum(y0f, f(-2)), f(H)).astype(np.int64)
    return x0, y0, (sx - x0f).astype(f), (sy - y0f).astype(f)


def mirror_cost(ref, views, homs, row_offset=0):
    """The cost volume as csrc/cost_volume.cu's kernel walks it: blocks of
    8 rows x 32 / (C / 8) pixels and kRun depths, a taps table per kChunk
    depths, each pixel's views in order, float32."""
    src = (CSRC / "cost_volume.cu").read_text()
    k_run = int(re.search(r"kRun = (\d+);", src).group(1))
    k_chunk = int(re.search(r"kChunk = (\d+);", src).group(1))
    Hl, W, C = ref.shape
    V1, D = homs.shape[:2]
    H = views.shape[1]
    G = C // 8
    TX, TY = 32 // G, 8
    f = np.float32
    inv = f(1) / f(V1 + 1)
    out = np.full((D, Hl, W, C), np.nan, np.float32)
    for ty0 in range(0, Hl, TY):
        for tx0 in range(0, W, TX):
            ys, xs = np.meshgrid(np.arange(ty0, min(ty0 + TY, Hl)),
                                 np.arange(tx0, min(tx0 + TX, W)), indexing="ij")
            r = ref[ys, xs]                                     # (ty, tx, C)
            for d0 in range(0, D, k_run):
                for dc in range(d0, min(D, d0 + k_run), k_chunk):
                    table = {(dd, v): _project(homs[v, dc + dd].reshape(-1), xs, row_offset + ys, H, W)
                             for dd in range(min(k_chunk, min(D, d0 + k_run) - dc))
                             for v in range(V1)}
                    for dd in range(min(k_chunk, min(D, d0 + k_run) - dc)):
                        s, s2 = r.copy(), r * r
                        for v in range(V1):
                            x0, y0, fx, fy = table[dd, v]
                            taps = []
                            for oy, ox in ((0, 0), (0, 1), (1, 0), (1, 1)):
                                yy, xx = y0 + oy, x0 + ox
                                inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                                val = views[v, np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
                                taps.append(np.where(inside[..., None], val, f(0)))
                            fx, fy = fx[..., None], fy[..., None]
                            top = (f(1) - fx) * taps[0] + fx * taps[1]
                            bot = (f(1) - fx) * taps[2] + fx * taps[3]
                            val = (f(1) - fy) * top + fy * bot
                            s, s2 = s + val, s2 + val * val
                        mean = s * inv
                        out[dc + dd, ys, xs] = s2 * inv - mean * mean
    return out


@pytest.mark.parametrize("row_offset,hl,C", [(0, 12, 16), (5, 6, 32), (0, 9, 24)])
def test_cost_mirror_matches_plain(row_offset, hl, C):
    """K1 (row offset 0, every row) and K1s (a row block at an offset, a
    ragged last tile), D = 21 over runs and chunks of depth."""
    rng = np.random.default_rng(row_offset + C)
    H, W, D = 12, 19, 21
    views = rng.standard_normal((2, H, W, C)).astype(np.float32)
    ref = rng.standard_normal((hl, W, C)).astype(np.float32)
    homs = np.zeros((2, D, 3, 3), np.float32)
    for v, (rot, shift) in enumerate(((0.03, 4.0), (-0.1, 9.0))):
        c, s = np.cos(rot), np.sin(rot)
        for d in range(D):
            t = d / (D - 1) - 0.5
            homs[v, d] = [[c, -s, shift * t], [s, c, 0.5 * t], [1e-3, -5e-4, 1.0]]
    got = mirror_cost(ref, views, homs, row_offset)
    want = sweep.cost_volume_plain(torch.from_numpy(ref), torch.from_numpy(views),
                                   torch.from_numpy(homs),
                                   row_offset if row_offset or hl != H else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
