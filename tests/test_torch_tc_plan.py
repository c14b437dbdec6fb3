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
    (torch.bfloat16, 3, 8, "simt"), (torch.bfloat16, 64, 256, "simt"),
    (torch.float32, 32, 8, "simt"), (torch.float32, 3, 8, "simt"),
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
