"""The parts of the tensor-core edition (`csrc/tc_conv.cuh`) that the CPU
reaches: the edition rule, the transposed conv's parity-class plan run by a
plain per-class PyTorch routine (`tc.deconv_by_classes`) against
`deconv_plain` and JAX's Pallas kernels in interpret mode, and the launch
plans of the path's layers.

Tolerance: float32 on both sides, sums in another order: 5e-5 absolute on
outputs of order 1, as tests/test_torch_kernels.py.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvsnet_tpu.ops.pallas.deconv2d import _rowdeconv2d_fwd_impl
from mvsnet_tpu.ops.pallas.deconv3d import _rowdeconv3d_fwd_impl
from mvsnet_tpu_torch.ops.kernels import conv, deconv, tc

ATOL, RTOL = 5e-5, 1e-5


def _inputs(seed, x_shape, k_shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    k = (rng.standard_normal(k_shape) * 0.1).astype(np.float32)
    b = rng.standard_normal(k_shape[-1]).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("dtype,cin,cout,want", [
    (torch.bfloat16, 8, 1, "tc"), (torch.bfloat16, 32, 8, "tc"),
    (torch.bfloat16, 128, 128, "tc"), (torch.bfloat16, 24, 12, "tc"),
    (torch.bfloat16, 3, 8, "tc"), (torch.bfloat16, 64, 256, "simt"),
    (torch.float32, 32, 8, "simt"), (torch.float32, 3, 8, "simt"),
    (torch.bfloat16, 1, 1, "tc"), (torch.bfloat16, 2, 8, "tc"), (torch.bfloat16, 5, 128, "tc"),
    (torch.bfloat16, 6, 4, "tc"), (torch.bfloat16, 10, 2, "tc"), (torch.bfloat16, 20, 8, "tc"),
    (torch.bfloat16, 5, 129, "simt"), (torch.float32, 5, 8, "simt"),
])
def test_edition_rule(dtype, cin, cout, want):
    assert conv.pick_edition(dtype, cin, cout) == want
    assert conv.pick_edition(dtype, cin, cout, "simt") == "simt"
    if want == "tc":
        assert conv.pick_edition(dtype, cin, cout, "tc") == "tc"
    else:
        with pytest.raises(ValueError, match="tensor-core"):
            conv.pick_edition(dtype, cin, cout, "tc")


def test_edition_request_is_checked_on_cpu():
    """The rule holds before the CPU's plain path: "tc" on float32 raises,
    an unknown edition raises, and a bf16 "tc" request runs the plain
    version there without counting a launch."""
    x = torch.zeros(1, 6, 6, 8)
    k = torch.zeros(3, 3, 8, 8)
    for fn in (conv.conv, deconv.deconv):
        with pytest.raises(ValueError, match="tensor-core"):
            fn(x, k, edition="tc")
        with pytest.raises(ValueError, match="edition"):
            fn(x, k, edition="wgmma")
    before = (dict(conv.launches_by_edition), dict(deconv.launches_by_edition))
    xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
    assert conv.conv(xb, kb, edition="tc").shape == (1, 6, 6, 8)
    assert deconv.deconv(xb, kb, edition="tc").shape == (1, 12, 12, 8)
    assert (conv.launches_by_edition, deconv.launches_by_edition) == before


@pytest.mark.parametrize("rank", [3, 2])
def test_classes_by_plain_convs_match_pallas(rank):
    """K = 3, lo = 0 (flax's transposed conv): the classes, each a stride-1
    conv scattered to its output parity, against JAX's kernel in interpret
    mode and against deconv_plain."""
    shape = (1, 3, 5, 7) if rank == 3 else (2, 5, 7)
    x, k, b = _inputs(3, shape + (16,), (3,) * rank + (16, 8))
    impl = _rowdeconv3d_fwd_impl if rank == 3 else _rowdeconv2d_fwd_impl
    for bias, relu in ((None, False), (b, True)):
        want = np.asarray(impl(jnp.asarray(x), jnp.asarray(k),
                               None if bias is None else jnp.asarray(bias), relu=relu,
                               interpret=True))
        args = (torch.from_numpy(x), torch.from_numpy(k),
                None if bias is None else torch.from_numpy(bias), relu)
        got = tc.deconv_by_classes(*args).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, deconv.deconv_plain(*args).numpy(), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("rank,k,spatial", [
    (2, 5, (16, 20)), (2, 5, (15, 21)), (2, 5, (9, 8)),      # conv9_0 / conv10_0 dx
    (2, 3, (16, 20)), (2, 3, (15, 21)),                      # 3x3 stride-2 dx
    (3, 3, (8, 6, 10)), (3, 3, (7, 9, 5)),
])
def test_classes_match_plain_at_the_input_gradients_lo(rank, k, spatial):
    """The adjoint of a stride-2 SAME conv of input size `spatial`, at the
    low pads `autograd.conv_input_grad` passes: classes == deconv_plain."""
    outs = [conv.same_pads(n, k, 2)[2] for n in spatial]
    los = [conv.same_pads(n, k, 2)[0] for n in spatial]
    g, q, _ = _inputs(4, (2, *outs, 8), (k,) * rank + (8, 4))
    args = (torch.from_numpy(g), torch.from_numpy(q), None, False, los, tuple(spatial))
    np.testing.assert_allclose(tc.deconv_by_classes(*args).numpy(),
                               deconv.deconv_plain(*args).numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k,lo,n,m", [(3, 0, 5, 10), (3, 1, 5, 9), (3, 2, 4, 6),
                                      (5, 1, 8, 16), (5, 2, 8, 15), (5, 0, 3, 4)])
def test_class_taps_cover_the_kernel_once(k, lo, n, m):
    """Along one axis the two parity classes take disjoint kernel slices
    that together are the whole kernel; the halo transposed conv's lo = 2
    included."""
    classes = tc.deconv_classes(k, (1, 1, n), (0, 0, lo), (1, 1, m), (False, False, True))
    idx = sorted(i for c in classes for i in range(c.start[2], k, c.step[2]))
    assert idx == list(range(k))
    assert sum(c.grid[2] for c in classes) == m
    assert all(len(range(c.start[2], k, 2)) == c.taps[2] for c in classes)


def _layer_plans():
    """(name, plan) of every conv and transposed conv shape of a bf16
    request at 1152x864, D=192 and of a train step's input gradients at
    640x480, through the same class builders the wrappers use."""
    out = []
    convs = [("3dconv0_1", (1, 192, 216, 288, 32), 3, 1, 8),
             ("3dconv1_0", (1, 192, 216, 288, 32), 3, 2, 16),
             ("3dconv3_1", (1, 24, 27, 36, 64), 3, 1, 64),
             ("3dconv6_2", (1, 192, 216, 288, 8), 3, 1, 1),
             ("2dconv4_1", (3, 54, 72, 128), 3, 1, 128),
             ("2dconv4_0", (3, 108, 144, 64), 3, 2, 128),
             ("2dconv0_2", (3, 864, 1152, 8), 3, 1, 8),
             ("conv9_0", (3, 864, 1152, 8), 5, 2, 16),
             ("3dconv0_1 dx", (1, 192, 120, 160, 8), 3, 1, 32)]
    for name, shape, k, s, cout in convs:
        rank = len(shape) - 2
        pads = [conv.same_pads(n, k, s) for n in shape[1:-1]]
        if rank == 2:
            pads = [(0, 0, 1)] + pads
        taps = (k,) * 3 if rank == 3 else (1, k, k)
        strides = (s,) * 3 if rank == 3 else (1, s, s)
        cls = tc.TapClass(taps, tuple(p[0] for p in pads), tuple(p[2] for p in pads))
        out.append((name, shape[-1], tc.plan(shape[-1], cout, strides, [cls])))
    deconvs = [("3dconv6_0", (1, 96, 108, 144, 16), 8, 3, None),
               ("3dconv4_0", (1, 24, 27, 36, 64), 32, 3, None),
               ("2dconv5_0", (3, 54, 72, 128), 64, 3, None),
               ("2dconv8_0", (3, 432, 576, 16), 8, 3, None),
               ("conv9_0 dx", (3, 240, 320, 16), 8, 5, (480, 640))]
    for name, shape, cout, k, outs in deconvs:
        rank = len(shape) - 2
        ins = shape[1:-1]
        outs = outs or tuple(2 * n for n in ins)
        los = [conv.same_pads(m, k, 2)[0] for m in outs] if k == 5 else [0] * rank
        if rank == 2:
            ins, los, outs = (1, *ins), (0, *los), (1, *outs)
        classes = tc.deconv_classes(k, ins, los, outs, (rank == 3, True, True))
        assert len(classes) == 2 ** rank
        out.append((name, shape[-1], tc.plan(shape[-1], cout, (1, 1, 1), classes)))
    return out


def test_launch_plans_of_the_path_fit_the_card():
    """Each plan's shared memory fits a block and holds its parts without
    overlap: the box (reused as the output stage), the weights, the zero
    row and the tap table."""
    plans = _layer_plans()
    for name, cin, p in plans:
        ws = tc.weight_row_stride(p.nt)
        m = math.prod(p.tile)
        assert (p.mt, p.warps) in tc.TILE_CHOICES[p.nt], name
        assert p.w_smem_off >= max(math.prod(p.box) * cin * 2, m * ws * 2), name
        assert m == 16 * p.warps * p.mt, name
        assert p.smem_bytes <= tc.SMEM_LIMIT, name
        rows = 2 * p.stream * cin if p.stream else p.kpad
        assert p.zero_off == p.w_smem_off + rows * ws * 2, name
        assert p.toff_off + 4 * tc.MAX_TAPS == p.smem_bytes, name
        assert not p.stream or cin % 16 == 0, name
    by_name = {name: p for name, _, p in plans}
    # the 128x128x9 weights do not fit beside a box: they stream
    assert by_name["2dconv4_1"].stream


def _struct_ints(src, name):
    """Ints declared in `struct <name> { ... }` of a CUDA header (scalars
    and fixed arrays of int), comments removed."""
    body = src[src.index(f"struct {name} {{"):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:body.index("};")])
    count = 0
    for decl in re.findall(r"\bint\s+([^;]+);", body):
        for item in decl.split(","):
            size = re.search(r"\[(\w+)\]", item)
            count += int(size.group(1)) if size else 1
    return count


def test_plan_ints_match_the_kernel_structs():
    """The kernel's `Plan` holds 40 header ints and its `ClassPlan` 20, as
    `plan_ints` lays them out (the static_asserts hold only on the card)."""
    src = (Path(tc.__file__).resolve().parents[2] / "csrc" / "tc_conv.cuh").read_text()
    assert _struct_ints(src, "ClassPlan") == 20
    head = src[src.index("struct Plan {"):]
    assert _struct_ints(src, "Plan") == 40, "header ints before `ClassPlan cls[...]`"
    assert "ClassPlan cls[kMaxClasses];" in head[:head.index("};")]


def test_plan_ints_layout():
    """200 ints, the layout of csrc/tc_conv.cuh's Plan: 40 header ints,
    then 20 per class (8 classes, unused ones zero); each class names the
    kernel index of its tap 0."""
    classes = tc.deconv_classes(3, (4, 5, 6), (0, 0, 0), (8, 10, 12), (True, True, True))
    p = tc.plan(16, 8, (1, 1, 1), classes)
    ints = tc.plan_ints(p, (1, 4, 5, 6, 16), (1, 8, 10, 12, 8), (3, 3, 3, 16, 8), (1, 1, 1),
                        (2, 2, 2), classes, True)
    assert ints.shape == (200,) and ints.dtype == np.int32
    assert ints[24] == 8 and ints[30] == p.grid_x and tuple(ints[31:33]) == (3, 3)
    for i, c in enumerate(classes):
        row = ints[40 + 20 * i:60 + 20 * i]
        assert tuple(row[:3]) == c.taps and tuple(row[12:15]) == c.start
        assert tuple(row[15:18]) == p.tiles[i]


# ---- Cin % 8 != 0: a mirror of the kernel's zero-padded staging

def _fields(src, name):
    """Field names of `struct <name> { int a, b; int c[2]; ... }` in order,
    arrays expanded, comments removed."""
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


_SRC = (Path(tc.__file__).resolve().parents[2] / "csrc" / "tc_conv.cuh").read_text()
PLAN_FIELDS, CLASS_FIELDS = _fields(_SRC, "Plan"), _fields(_SRC, "ClassPlan")


def _swizzle(nch):
    """csrc/tc_conv.cuh `Swizzle`: the chunk slot of (position, chunk)."""
    shift = mask = 0
    if nch & (nch - 1) == 0:
        if nch >= 8:
            mask = 7
        elif nch > 1:
            mask, shift = nch - 1, (1 if nch == 4 else 2)
    return lambda pix, c: pix * nch + (c ^ ((pix >> shift) & mask))


def mirror_tc_conv(x5, k5, bias, strides, ostrides, classes, relu):
    """out5 as csrc/tc_conv.cuh computes it, from the plan ints alone:
    each tile's box staged into a simulated shared memory (NaN where
    nothing is staged) as the aligned or the element-by-element path
    stages it, the weight rows as `load_weights` lays them out (zero past
    Cin and past the last tap), the tap table, and every output row's sum
    over the k units in the kernel's order; float64."""
    B = x5.shape[0]
    cin, cout = x5.shape[-1], k5.shape[-1]
    out_shape = [B] + [max((c.grid[a] - 1) * c.step[a] + c.offset[a] + 1 for c in classes)
                       for a in range(3)] + [cout]
    p = tc.plan(cin, cout, strides, classes, B)
    assert not p.stream
    ints = tc.plan_ints(p, x5.shape, out_shape, k5.shape, strides, ostrides, classes, relu)
    P = dict(zip(PLAN_FIELDS, ints[:40].tolist()))
    nch, BZ, BY, BX = P["nch"], P["BZ"], P["BY"], P["BX"]
    G8, swz = 8 * nch, _swizzle(nch)
    half_x = (BX + 1) >> 1
    xpos = (lambda bx: (bx & 1) * half_x + (bx >> 1)) if P["sw"] == 2 else (lambda b: b)
    x = x5.astype(np.float64)
    xflat = x.reshape(B, P["Di"], P["Hi"], P["Wi"] * cin)
    w = k5.astype(np.float64).reshape(-1, cout)
    out = np.full(out_shape, np.nan)
    TZ, TY, TX = P["TZ"], P["TY"], P["TX"]
    M = TZ * TY * TX
    rows = np.arange(M)
    lz, ly, lx = rows // (TY * TX), (rows // TX) % TY, rows % TX
    rowpix = (lz * P["sd"] * BY + ly * P["sh"]) * BX + lx
    for ci_, cls_ints in enumerate(ints[40:].reshape(8, 20)[:P["nclass"]]):
        cp = dict(zip(CLASS_FIELDS, cls_ints.tolist()))
        taps = cp["kd"] * cp["kh"] * cp["kw"]
        wsm = np.zeros((P["kpad"], cout))
        for r in range(taps * G8):
            t, ci = divmod(r, G8)
            if ci >= cin:
                continue
            a, rem = divmod(t, cp["kh"] * cp["kw"])
            bb, ex = divmod(rem, cp["kw"])
            krow = (((cp["sz"] + a * P["osd"]) * P["KH"] + cp["sy"] + bb * P["osh"]) * P["KW"]
                    + cp["sx"] + ex * P["osw"]) * cin + ci
            wsm[r] = w[krow]
        toff = []
        for t in range(taps):
            a, rem = divmod(t, cp["kh"] * cp["kw"])
            bb, e = divmod(rem, cp["kw"])
            toff.append((a * BY + bb) * BX + xpos(e))
        ksteps = -(-taps * nch // 2)
        for b in range(B):
            for tz in range(cp["tz"]):
                for ty in range(cp["ty"]):
                    for tx in range(cp["tx"]):
                        gz0, gy0, gx0 = tz * TZ, ty * TY, tx * TX
                        iz0 = gz0 * P["sd"] - cp["pd"]
                        iy0 = gy0 * P["sh"] - cp["ph"]
                        ix0 = gx0 * P["sw"] - cp["pw"]
                        smem = np.full((P["box_bytes"] // 16, 8), np.nan)
                        for q in range(BZ * BY * BX * nch):
                            pix, c = divmod(q, nch)
                            r, bx = divmod(pix, BX)
                            bz, by = divmod(r, BY)
                            iz, iy = iz0 + bz, iy0 + by
                            inside = 0 <= iz < P["Di"] and 0 <= iy < P["Hi"]
                            vals = np.zeros(8)
                            if cin % 8 == 0:
                                ix = ix0 + bx
                                if inside and 0 <= ix < P["Wi"]:
                                    vals = x[b, iz, iy, ix, 8 * c:8 * c + 8]
                            else:
                                f0 = (ix0 + bx) * cin + 8 * c
                                for i in range(8):
                                    f = f0 + i
                                    if inside and 8 * c + i < cin and 0 <= f < P["Wi"] * cin:
                                        vals[i] = xflat[b, iz, iy, f]
                            smem[swz(pix - bx + xpos(bx), c)] = vals
                        acc = np.zeros((M, cout))
                        for u in range(2 * ksteps):
                            tl, c = divmod(u, nch)
                            if tl >= taps:         # the tap table's -1: the zero row
                                arow = np.zeros((M, 8))
                            else:
                                arow = smem[[swz(pix, c) for pix in rowpix + toff[tl]]]
                            acc += arow @ wsm[8 * u:8 * u + 8]
                        if bias is not None:
                            acc += bias
                        if relu:
                            acc = np.maximum(acc, 0)
                        gz, gy, gx = gz0 + lz, gy0 + ly, gx0 + lx
                        keep = (gz < cp["Dc"]) & (gy < cp["Hc"]) & (gx < cp["Wc"])
                        out[b, gz[keep] * P["osd"] + cp["oz"], gy[keep] * P["osh"] + cp["oy"],
                            gx[keep] * P["osw"] + cp["ox"]] = acc[keep]
    assert not np.isnan(out).any(), "an output unwritten, or a NaN chunk read"
    return out


def _conv_case(seed, shape, cout, k, stride):
    x, kern, b = _inputs(seed, shape, (k,) * (len(shape) - 2) + (shape[-1], cout))
    rank = len(shape) - 2
    pads = [conv.same_pads(n, k, stride) for n in shape[1:-1]]
    if rank == 2:
        pads = [(0, 0, 1)] + pads
    taps = (k,) * 3 if rank == 3 else (1, k, k)
    strides = (stride,) * 3 if rank == 3 else (1, stride, stride)
    cls = tc.TapClass(taps, tuple(p[0] for p in pads), tuple(p[2] for p in pads))
    x5 = x[:, None] if rank == 2 else x
    k5 = kern[None] if rank == 2 else kern
    return x, kern, b, x5, k5, strides, [cls]


@pytest.mark.parametrize("cin,shape_hw,k,stride", [
    (1, (9, 13), 3, 1), (2, (9, 13), 3, 1), (3, (9, 13), 3, 1), (5, (8, 12), 3, 1),
    (6, (7, 11), 3, 1), (10, (7, 9), 3, 1), (3, (9, 13), 3, 2), (5, (10, 11), 3, 2),
    (3, (11, 13), 5, 2),
])
def test_small_cin_mirror_matches_plain_2d(cin, shape_hw, k, stride):
    """Cin % 8 != 0 zero-padded per pixel, 2D 3x3 s1, 3x3 s2 and 5x5 s2,
    with a bias and a ReLU: the kernel's arithmetic mirrored from its plan
    ints equals `conv_plain`."""
    x, kern, b, x5, k5, strides, classes = _conv_case(cin * 7 + k + stride, (2, *shape_hw, cin),
                                                      8 if cin != 5 else 5, k, stride)
    got = mirror_tc_conv(x5, k5, b, strides, (1, 1, 1), classes, True)[:, 0]
    want = conv.conv_plain(torch.from_numpy(x), torch.from_numpy(kern), torch.from_numpy(b),
                           stride, True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cin", [1, 3, 8])
def test_small_cin_mirror_matches_plain_3d(cin):
    """3x3x3 s1 at Cin 1 (3dconv6_2's input gradient) and 3, and the
    aligned Cin = 8 path through the same mirror."""
    x, kern, _, x5, k5, strides, classes = _conv_case(cin, (1, 4, 6, 9, cin), 4, 3, 1)
    got = mirror_tc_conv(x5, k5, None, strides, (1, 1, 1), classes, False)
    want = conv.conv_plain(torch.from_numpy(x), torch.from_numpy(kern)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rank,cin", [(2, 3), (2, 6), (3, 2), (3, 5)])
def test_small_cin_mirror_matches_plain_transposed(rank, cin):
    """The transposed conv's parity classes (kernel slices w[s::2], outputs
    at out[2 j + r]) at Cin % 8 != 0: the mirror equals `deconv_plain`."""
    shape = (1, 3, 4, 5) if rank == 3 else (2, 4, 6)
    x, kern, b = _inputs(rank + cin, shape + (cin,), (3,) * rank + (cin, 8))
    x5 = x[:, None] if rank == 2 else x
    k5 = kern[None] if rank == 2 else kern
    ins = x5.shape[1:-1]
    outs = tuple(2 * n for n in ins) if rank == 3 else (1, *(2 * n for n in ins[1:]))
    classes = tc.deconv_classes(3, ins, (0, 0, 0), outs, (rank == 3, True, True))
    got = mirror_tc_conv(x5, k5, b, (1, 1, 1), (2 if rank == 3 else 1, 2, 2), classes, True)
    want = deconv.deconv_plain(torch.from_numpy(x), torch.from_numpy(kern), torch.from_numpy(b),
                               True).numpy()
    np.testing.assert_allclose(got[:, 0] if rank == 2 else got, want, atol=ATOL, rtol=RTOL)


def test_small_cin_plans_fit_the_card():
    """The plans of every Cin % 8 != 0 conv on the paths (the images' 3,
    the refinement's 5, the GRU cells' 1, 2, 6, 10, 20 and 3dconv6_2's
    input gradient at 1) fit a block's shared memory without overlap."""
    for cin, shape, cout, k, s in ((3, (3, 1, 864, 1152), 8, 3, 1), (3, (3, 1, 864, 1152), 16, 3, 2),
                                   (5, (1, 1, 864, 1152), 8, 3, 1), (5, (1, 1, 864, 1152), 16, 3, 2),
                                   (20, (1, 1, 296, 400), 8, 3, 1), (6, (1, 1, 296, 400), 4, 3, 1),
                                   (2, (1, 1, 296, 400), 1, 3, 1), (10, (1, 1, 120, 160), 4, 3, 1),
                                   (1, (1, 192, 120, 160), 8, 3, 1)):
        taps = (k,) * 3 if shape[1] > 1 else (1, k, k)
        strides = (s,) * 3 if shape[1] > 1 else (1, s, s)
        pads = [conv.same_pads(n, kk, ss) for n, kk, ss in zip(shape[1:], taps, strides)]
        cls = tc.TapClass(taps, tuple(p[0] for p in pads), tuple(p[2] for p in pads))
        p = tc.plan(cin, cout, strides, [cls], shape[0])
        m = math.prod(p.tile)
        assert p.nch == -(-cin // 8)
        assert p.w_smem_off >= max(math.prod(p.box) * p.nch * 16, m * tc.weight_row_stride(p.nt) * 2)
        assert p.kpad >= math.prod(taps) * p.nch * 8 and p.kpad % 16 == 0
        assert p.smem_bytes <= tc.SMEM_LIMIT and not p.stream
