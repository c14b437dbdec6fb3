"""Time the tensor-core conv kernel's candidate tilings (`tc.candidates`)
at every conv and transposed-conv shape of a bf16 request at 1152x864,
D=192, V=3, on one card: the data the planner's cost model was fitted to;
then the layers of the paths whose Cin is not a multiple of 8 (zero-padded
in shared memory).

    python3 tools/tc_tile_sweep.py            # on a machine with an H100
    python3 tools/tc_tile_sweep.py --small    # the Cin % 8 != 0 layers only

Per layer: the planner's pick, the fastest candidate timed, and the
wrapper's time (launch overhead included); every candidate's output must
equal the wrapper's bit for bit (eq1), since a tile plan does not change
any output's order of summation. Then one line with every candidate timed
(ms/mt<MT>w<warps>(tile)s<stream>b<buffers>p<persistent>), and at the end
the sums of each group of layers.
"""
import ctypes
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from mvsnet_tpu_torch.ops.kernels import _lib, conv, deconv, tc  # noqa: E402

MAX_CANDIDATES = 24

# (name, kind, input (B, D, H, W, Cin), taps, strides, Cout); 2D layers have
# D = 1, taps (1, k, k) and strides (1, s, s)
LAYERS = []
SMALL = []          # Cin % 8 != 0: the same


def conv2d(name, B, H, W, cin, cout, k=3, s=1):
    LAYERS.append((name, "conv", (B, 1, H, W, cin), (1, k, k), (1, s, s), cout))


def conv3d(name, D, H, W, cin, cout, s=1):
    LAYERS.append((name, "conv", (1, D, H, W, cin), (3, 3, 3), (s, s, s), cout))


def deconv2d(name, B, H, W, cin, cout):
    LAYERS.append((name, "deconv2", (B, 1, H, W, cin), None, None, cout))


def deconv3d(name, D, H, W, cin, cout):
    LAYERS.append((name, "deconv3", (1, D, H, W, cin), None, None, cout))


# the feature tower (3 views) at 1152x864
conv2d("2dconv2_0", 3, 432, 576, 16, 32, s=2)
conv2d("2dconv3_0", 3, 216, 288, 32, 64, s=2)
conv2d("2dconv4_0", 3, 108, 144, 64, 128, s=2)
conv2d("2dconv0_2", 3, 864, 1152, 8, 8)
conv2d("2dconv1_x", 3, 432, 576, 16, 16)
conv2d("2dconv2_x", 3, 216, 288, 32, 32)
conv2d("2dconv3_x", 3, 108, 144, 64, 64)
conv2d("2dconv4_x", 3, 54, 72, 128, 128)
deconv2d("2dconv5_0", 3, 54, 72, 128, 64)
conv2d("2dconv5_1", 3, 108, 144, 128, 64)
deconv2d("2dconv6_0", 3, 108, 144, 64, 32)
conv2d("2dconv6_1", 3, 216, 288, 64, 32)
deconv2d("2dconv7_0", 3, 216, 288, 32, 16)
conv2d("2dconv7_1", 3, 432, 576, 32, 16)
deconv2d("2dconv8_0", 3, 432, 576, 16, 8)
conv2d("2dconv8_1", 3, 864, 1152, 16, 8)
conv2d("conv9_0", 3, 864, 1152, 8, 16, k=5, s=2)
conv2d("conv10_0", 3, 432, 576, 16, 32, k=5, s=2)
# the U-Net over the cost volume, D=192 at 288x216
conv3d("3dconv1_0", 192, 216, 288, 32, 16, 2)
conv3d("3dconv2_0", 96, 108, 144, 16, 32, 2)
conv3d("3dconv3_0", 48, 54, 72, 32, 64, 2)
conv3d("3dconv0_1", 192, 216, 288, 32, 8)
conv3d("3dconv1_1", 96, 108, 144, 16, 16)
conv3d("3dconv2_1", 48, 54, 72, 32, 32)
conv3d("3dconv3_1", 24, 27, 36, 64, 64)
deconv3d("3dconv4_0", 24, 27, 36, 64, 32)
deconv3d("3dconv5_0", 48, 54, 72, 32, 16)
deconv3d("3dconv6_0", 96, 108, 144, 16, 8)
conv3d("3dconv6_2", 192, 216, 288, 8, 1)


# Cin % 8 != 0 on the paths: the image convs, the refinement net's first
# convs, the GRU cells at the serving point and at the train_gru point
# (forward and input gradients), 3dconv6_2's input gradient
for name, B, H, W, cin, cout, s in (
        ("2dconv0_1", 3, 864, 1152, 3, 8, 1), ("2dconv1_0", 3, 864, 1152, 3, 16, 2),
        ("2dconv0_1_refine", 1, 864, 1152, 5, 8, 1), ("2dconv1_0_refine", 1, 864, 1152, 5, 16, 2),
        ("gru2_gates", 1, 296, 400, 20, 8, 1), ("gru2_output", 1, 296, 400, 20, 4, 1),
        ("gru3_gates", 1, 296, 400, 6, 4, 1), ("gru3_output", 1, 296, 400, 6, 2, 1),
        ("prob_conv", 1, 296, 400, 2, 1, 1),
        ("lite_gru2_gates", 1, 120, 160, 10, 4, 1), ("lite_gru2_output", 1, 120, 160, 10, 2, 1),
        ("lite_gru3_gates", 1, 120, 160, 3, 2, 1), ("lite_gru3_output", 1, 120, 160, 3, 1, 1),
        ("lite_prob_conv", 1, 120, 160, 1, 1, 1),
        ("lite_gru2_gates_dx", 1, 120, 160, 4, 10, 1), ("lite_gru2_output_dx", 1, 120, 160, 2, 10, 1),
        ("lite_gru3_gates_dx", 1, 120, 160, 2, 3, 1), ("lite_gru3_output_dx", 1, 120, 160, 1, 3, 1)):
    SMALL.append((name, "conv", (B, 1, H, W, cin), (1, 3, 3), (1, s, s), cout))
SMALL.append(("3dconv6_2_dx", "conv", (1, 192, 120, 160, 1), (3, 3, 3), (1, 1, 1), 8))


def event_ms(fn, iters=None):
    """Mean ms of one call of fn by CUDA events, after a warm-up call; as
    many calls as fit in about 0.1 s (3 to 30)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    iters = iters or int(min(30, max(3, 0.1 / max(dt, 1e-6))))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def layer_call(kind, xs, taps, strides, cout, randn):
    """(classes, strides, output strides, library, kernel, wrapper call,
    output shape) of one layer."""
    cin = xs[-1]
    x5 = randn(xs)
    if kind == "conv":
        kd, kh, kw = taps
        pads = [conv.same_pads(n, k, s) for n, k, s in zip(xs[1:4], taps, strides)]
        classes = (tc.TapClass(taps, tuple(p[0] for p in pads), tuple(p[2] for p in pads)),)
        outs = tuple(p[2] for p in pads)
        k5 = randn((kd, kh, kw, cin, cout), (kd * kh * kw * cin) ** -0.5)
        flat = kd == 1

        def wrap():
            return conv.conv(x5[:, 0] if flat else x5, k5[0] if flat else k5, None, strides[1])
        return x5, k5, classes, strides, (1, 1, 1), "conv", wrap, (xs[0], *outs, cout)
    r3 = kind == "deconv3"
    outs = (2 * xs[1] if r3 else 1, 2 * xs[2], 2 * xs[3])
    classes = tc.deconv_classes(3, xs[1:4], (0, 0, 0), outs, (r3, True, True))
    k5 = randn((3 if r3 else 1, 3, 3, cin, cout), (9 * cin) ** -0.5)

    def wrap():
        return deconv.deconv(x5 if r3 else x5[:, 0], k5 if r3 else k5[0])
    return x5, k5, classes, (1, 1, 1), (2 if r3 else 1, 2, 2), "deconv", wrap, (xs[0], *outs, cout)


def describe(ms, p, same):
    return (f"{ms:.4f} mt{p.mt}w{p.warps} {p.tile} st{int(p.stream)} nb{p.nbuf} "
            f"ps{int(p.persist)} bps{tc.blocks_per_sm(p)} smem{p.smem_bytes // 1024}K "
            f"eq{int(same)}")


def sweep_layer(name, kind, xs, taps, strides, cout, randn, dev):
    """Time up to MAX_CANDIDATES tilings of one layer; returns (pick ms,
    best ms, wrapper ms)."""
    x5, k5, classes, strides, ostrides, lib, wrap, out_shape = layer_call(
        kind, xs, taps, strides, cout, randn)
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=dev)
    fn = _lib.launcher(lib, tc._ARGTYPES, entry="tc_launch")
    cands = sorted(tc.candidates(xs[-1], cout, strides, classes, xs[0]), key=lambda kp: kp[0])
    # the 8 cheapest by the model, then one of each other kind of plan
    seen, chosen = set(), []
    for _, p in cands:
        kind_of = (p.mt, p.warps, p.stream, p.nbuf, p.persist)
        if len(chosen) < 8 or kind_of not in seen:
            chosen.append(p)
            seen.add(kind_of)
    ref = wrap().reshape(out.shape)
    res = []
    for p in chosen[:MAX_CANDIDATES]:
        ints = tc.plan_ints(p, xs, out.shape, k5.shape, strides, ostrides, classes, False)

        def call(p=p, ints=ints):
            _lib.check(lib, fn(p.nt, p.mt, p.warps, ints.ctypes.data_as(ctypes.c_void_p),
                               _lib.ptr(x5), _lib.ptr(k5), None, _lib.ptr(out),
                               _lib.stream_of(x5)))
        ms = event_ms(call)
        res.append((ms, p, torch.equal(out, ref)))
    wms = event_ms(wrap)
    best = min(res, key=lambda r: r[0])
    print(f"{name:10s} pick {describe(*res[0])} | best {describe(*best)} | wrapper {wms:.4f}")
    print("    all: " + "; ".join(
        f"{ms:.3f}/mt{p.mt}w{p.warps}{p.tile}s{int(p.stream)}b{p.nbuf}p{int(p.persist)}"
        for ms, p, _ in res))
    return res[0][0], best[0], wms


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("tc_tile_sweep: no CUDA device")
    small_only = sys.argv[1:] == ["--small"]
    t0 = time.perf_counter()
    _lib.build_all()
    print("build", round(time.perf_counter() - t0, 1))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    for group in ((SMALL,) if small_only else (LAYERS, SMALL)):
        tot_pick = tot_best = tot_wrap = 0.0
        for name, kind, xs, taps, strides, cout in group:
            pick, best, wms = sweep_layer(name, kind, xs, taps, strides, cout, randn, dev)
            tot_pick, tot_best, tot_wrap = tot_pick + pick, tot_best + best, tot_wrap + wms
            torch.cuda.empty_cache()
        print(f"sum pick {tot_pick:.4f} best {tot_best:.4f} wrapper {tot_wrap:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
