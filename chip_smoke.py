"""Drive the PyTorch/CUDA port (`mvsnet_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):
  1. the card's name and power limit; exits at once without CUDA;
  2. builds the CUDA kernels from `mvsnet_tpu_torch/csrc` with nvcc (sm_90a)
     and prints each kernel's registers, stack and spills;
  3. holds every kernel against its plain PyTorch version on the card at
     the main path's shapes, in float32 and bfloat16, then times kernel,
     plain version and the one PyTorch library call for the same function
     (CUDA events, after a warm-up) beside the least time the card could
     take (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16 or 67 TFLOP/s
     float32, whichever is larger);
  4. the main path: `Predictor` at 1152x864, D=192, 3 views, "normal",
     bfloat16, seeded weights, answers 3 requests; launch counts per
     request are asserted (cost volume 1, conv 36, deconv 7), then one more
     request is timed stage by stage;
  5. end to end at 320x256, D=32, "normal", float32: the card's kernel path
     against the CPU's plain path with the same weights and inputs.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# max |kernel - plain| <= TOL * max(1, max |plain|): float32 sums in another
# order; for bf16 also one rounding of the output (2^-8 relative).
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# end to end, float32, card kernels vs the CPU's plain path: sums in another
# order through ~45 layers and a softmax over 32 planes
E2E_DEPTH_ATOL = 0.05          # depth units; the plane interval is 15
E2E_PROB_ATOL = 1e-3
EXPECTED_LAUNCHES = {"cost_volume": 1, "conv": 36, "deconv": 7}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, budget_s=0.25, max_iters=50):
    """Mean ms per call over a run of calls, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(max_iters, max(3, budget_s / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def scene(B, V, H, W, D, seed):
    """Seeded images (B, V, H, W, 3) and cams at the cost-volume resolution
    (H/4, W/4): views displaced by up to 60 mm and turned by up to 2.3
    degrees, depths from 425 mm over about 480 mm (DTU-like)."""
    rng = np.random.default_rng(seed)
    h, w = H // 4, W // 4
    f = 0.8 * w
    interval = 480.0 / D
    cams = np.zeros((B, V, 2, 4, 4), np.float32)
    offsets = [(0.0, 0.0), (60.0, 0.0), (-40.0, 30.0), (30.0, -50.0)]
    for v in range(V):
        a = 0.02 * v
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        cams[:, v, 0, :3, :3] = R
        cams[:, v, 0, :2, 3] = offsets[v % len(offsets)]
        cams[:, v, 0, 3, 3] = 1.0
        cams[:, v, 1, :3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
        cams[:, v, 1, 3] = [425.0, interval, D, 425.0 + (D - 1) * interval]
    images = rng.standard_normal((B, V, H, W, 3)).astype(np.float32)
    return images, cams


def summarize_build(lib):
    """One line per compiled kernel: registers, stack, spills, static
    shared memory."""
    import re

    for name, log in lib.build_logs.items():
        entry, props = None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry, props = m.group(1), {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and entry:
                props.update(stack=m.group(1), spill_st=m.group(2), spill_ld=m.group(3))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                props["regs"] = m.group(1)
                # the weights live in dynamic shared memory, sized per launch
                sm = re.search(r"(\d+) bytes smem", line)
                props["static_smem"] = sm.group(1) if sm else "0"
                try:
                    short = subprocess.run(["c++filt", entry], capture_output=True,
                                           text=True, timeout=10).stdout.strip()
                except FileNotFoundError:
                    short = entry
                short = short.replace("(anonymous namespace)::", "").removeprefix("void ")
                short = re.sub(r"\(.*\)$", "", short)
                print(f"  {name}: {short} " + " ".join(f"{k}={v}" for k, v in props.items()))
                entry = None


def valid_taps(n, k, s, lo, out):
    """Sum over outputs of the taps inside the input, along one axis."""
    return sum(sum(1 for t in range(k) if 0 <= o * s - lo + t < n) for o in range(out))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    print(f"card: {smi}")
    torch.backends.cudnn.allow_tf32 = False          # float32 references stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.ops.geometry import homographies_for_views
    from mvsnet_tpu_torch.ops.kernels import _lib, conv, deconv, sweep
    from mvsnet_tpu_torch.predict import Predictor, depth_params_from_cams

    # ---- 2. build
    t0 = time.perf_counter()
    _lib.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_lib.SOURCES)} "
          f"(nvcc {' '.join(_lib.NVCC_FLAGS)})")
    summarize_build(_lib)

    # ---- 3. kernels against their plain versions at the main path's shapes
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    images, cams = scene(1, 3, 864, 1152, 192, seed=0)
    ds, di, _, _ = depth_params_from_cams(cams)
    homs = homographies_for_views(torch.from_numpy(cams).to(dev), 192,
                                  torch.from_numpy(ds).to(dev),
                                  torch.from_numpy(di).to(dev))[:, 0].contiguous()
    cases = []     # one dict per kernel and shape

    def add_cost():
        def make(dtype):
            return (randn((216, 288, 32), dtype), randn((2, 216, 288, 32), dtype), homs)
        n_out = 192 * 216 * 288 * 32
        ops = n_out * (12 * 2 + 4) + 192 * 216 * 288 * 2 * 25
        cases.append(dict(
            name="cost_volume", mod=sweep, kernel=sweep.cost_volume,
            plain=sweep.cost_volume_plain, library=None, make=make,
            bytes=lambda it: (3 * 216 * 288 * 32 + n_out) * it + homs.numel() * 4,
            ops=ops, source="mvsnet_tpu_torch/csrc/cost_volume.cu",
            replaces="mvsnet_tpu/ops/pallas/sweep.py:1094"))

    def add_conv(layer, shape, k, stride, cout, epilogue, replaces):
        cin = shape[-1]
        rank = len(shape) - 2

        def make(dtype):
            x = randn(shape, dtype)
            w = randn((k,) * rank + (cin, cout), dtype, (k ** rank * cin) ** -0.5)
            b = randn((cout,), torch.float32) if epilogue else None
            return x, w, b

        pads = [conv.same_pads(n, k, stride) for n in shape[1:-1]]
        taps = np.prod([valid_taps(n, k, stride, lo, out)
                        for n, (lo, _, out) in zip(shape[1:-1], pads)])
        n_out = shape[0] * int(np.prod([p[2] for p in pads])) * cout

        def library(x, w, b):
            xc = x.movedim(-1, 1)
            wc = w.permute(rank + 1, rank, *range(rank))
            if stride == 1:
                return (F.conv3d if rank == 3 else F.conv2d)(xc, wc, b, padding=k // 2)
            return (F.conv3d if rank == 3 else F.conv2d)(xc, wc, b, stride=stride)

        def library_inputs(x, w, b):
            # channels-last activations and weights for cuDNN; the asymmetric
            # SAME pad of a stride-2 conv is applied beforehand, untimed
            xin = x
            if stride == 2:
                flat = [p for lo, hi, _ in reversed(pads) for p in (lo, hi)]
                xin = F.pad(x.movedim(-1, 1), flat).movedim(1, -1).contiguous()
            return xin, w, None if b is None else b.to(x.dtype)

        cases.append(dict(
            name=f"conv:{layer}", mod=conv,
            kernel=lambda x, w, b: conv.conv(x, w, b, stride, epilogue),
            plain=lambda x, w, b: conv.conv_plain(x, w, b, stride, epilogue),
            library=library, library_inputs=library_inputs, make=make,
            bytes=lambda it: (int(np.prod(shape)) + k ** rank * cin * cout + n_out) * it,
            ops=2 * cin * cout * int(taps) * shape[0],
            source="mvsnet_tpu_torch/csrc/conv.cu", replaces=replaces))

    def add_deconv(layer, shape, cout, epilogue, replaces):
        cin = shape[-1]
        rank = len(shape) - 2

        def make(dtype):
            x = randn(shape, dtype)
            w = randn((3,) * rank + (cin, cout), dtype, (9 * cin) ** -0.5)
            b = randn((cout,), torch.float32) if epilogue else None
            return x, w, b

        n_out = shape[0] * 2 ** rank * int(np.prod(shape[1:-1])) * cout
        taps = int(np.prod([3 * n - 1 for n in shape[1:-1]]))

        def library(x, w, b):
            wt = w.flip(list(range(rank))).permute(rank, rank + 1, *range(rank))
            y = (F.conv_transpose3d if rank == 3 else F.conv_transpose2d)(
                x.movedim(-1, 1), wt, b, stride=2)
            return y[(..., *(slice(0, 2 * n) for n in shape[1:-1]))]

        cases.append(dict(
            name=f"deconv:{layer}", mod=deconv,
            kernel=lambda x, w, b: deconv.deconv(x, w, b, epilogue),
            plain=lambda x, w, b: deconv.deconv_plain(x, w, b, epilogue),
            library=library,
            library_inputs=lambda x, w, b: (x, w, None if b is None else b.to(x.dtype)),
            make=make,
            bytes=lambda it: (int(np.prod(shape)) + 9 * 3 ** (rank - 2) * cin * cout
                              + n_out) * it,
            ops=2 * cin * cout * taps * shape[0],
            source="mvsnet_tpu_torch/csrc/deconv.cu", replaces=replaces))

    c3, c2s1, c2s2 = ("mvsnet_tpu/ops/pallas/conv3d.py:974",
                      "mvsnet_tpu/ops/pallas/conv2d.py:871",
                      "mvsnet_tpu/ops/pallas/conv2d.py:578")
    add_cost()
    add_conv("3dconv0_1", (1, 192, 216, 288, 32), 3, 1, 8, True, c3)
    add_conv("3dconv1_0", (1, 192, 216, 288, 32), 3, 2, 16, True, c3)
    add_conv("3dconv3_1", (1, 24, 27, 36, 64), 3, 1, 64, True, c3)
    add_conv("2dconv0_1", (3, 864, 1152, 3), 3, 1, 8, False, c2s1)
    add_conv("2dconv4_1", (3, 54, 72, 128), 3, 1, 128, False, c2s1)
    add_conv("conv9_0", (3, 864, 1152, 8), 5, 2, 16, False, c2s2)
    add_deconv("3dconv6_0", (1, 96, 108, 144, 16), 8, True,
               "mvsnet_tpu/ops/pallas/deconv3d.py:194")
    add_deconv("3dconv4_0", (1, 24, 27, 36, 64), 32, True,
               "mvsnet_tpu/ops/pallas/deconv3d.py:194")
    add_deconv("2dconv8_0", (3, 432, 576, 16), 8, False,
               "mvsnet_tpu/ops/pallas/deconv2d.py:185")

    print("kernel phase: kernel vs plain version on the card "
          f"(pass: max abs err <= tol * max(1, max|plain|), tol {TOL[torch.float32]:g} "
          f"f32, {TOL[torch.bfloat16]:g} bf16)")
    failures, records = [], {}
    for c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = c["make"](dtype)
            before = c["mod"].launches
            got = c["kernel"](*inputs)
            want = c["plain"](*inputs)
            torch.cuda.synchronize()
            if c["mod"].launches != before + 1:
                failures.append(f"{c['name']} {dtype}: the wrapper did not launch its kernel")
                continue
            if got.shape != want.shape:
                failures.append(f"{c['name']} {dtype}: shape {tuple(got.shape)} != "
                                f"{tuple(want.shape)}")
                continue
            got, want = got.float(), want.float()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= TOL[dtype] * max(1.0, scale)
            del got, want
            ms = cuda_time_ms(lambda: c["kernel"](*inputs))
            plain_ms = cuda_time_ms(lambda: c["plain"](*inputs), max_iters=10)
            lib_ms = None
            if c["library"] is not None:
                lib_in = c["library_inputs"](*inputs)
                lib_ms = cuda_time_ms(lambda: c["library"](*lib_in))
                del lib_in
            it = torch.tensor([], dtype=dtype).element_size()
            t_bytes = c["bytes"](it) / HBM_BYTES_PER_S * 1e3
            t_ops = c["ops"] / PEAK_OPS[dtype] * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            tag = str(dtype).replace("torch.", "")
            print(f"  {c['name']:18s} {tag:8s} max_abs_err {err:.3e} max_rel_err "
                  f"{err / max(scale, 1e-30):.3e} {'ok' if ok else 'FAIL'} | "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                  f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound {bound_ms:.4f} ms "
                  f"({bound_by}: {c['bytes'](it) / 1e6:.1f} MB, {c['ops'] / 1e9:.2f} GFLOP)")
            if not ok:
                failures.append(f"{c['name']} {tag}: max abs err {err:.3e} (max|plain| {scale:.3e})")
            records[(c["name"], tag)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)
            del inputs
            torch.cuda.empty_cache()
    if failures:
        print("kernel phase FAILED:\n  " + "\n  ".join(failures))
        return 1

    # ---- 4. the main path: 3 requests at the operating point
    cfg = ModelConfig(view_num=3, max_d=192, width=1152, height=864,
                      network_mode="normal", compute_dtype="bfloat16")
    predictor = Predictor(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_request = [], []
    for _ in range(3):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        depth, prob, _ = predictor.predict(images, cams, ds, di, fetch=False)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after = kernels.launch_counts()
        per_request.append({k: after[k] - before[k] for k in after})
        if not (torch.isfinite(depth).all() and torch.isfinite(prob).all()):
            print("main path FAILED: non-finite depth or prob")
            return 1
    run_launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: 3 requests at 1152x864, D=192, V=3, normal, bf16: wall ms "
          f"{', '.join(f'{w:.2f}' for w in walls)}; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"depth {tuple(depth.shape)} in [{depth.min().item():.1f}, {depth.max().item():.1f}], "
          f"prob in [{prob.min().item():.3f}, {prob.max().item():.3f}]")
    print(f"  launches per request: {per_request}")
    if any(r != EXPECTED_LAUNCHES for r in per_request):
        print(f"main path FAILED: launches per request {per_request} != {EXPECTED_LAUNCHES}")
        return 1

    # one more request, stage by stage (after the counts were read)
    model = predictor.model
    stages = {}
    with torch.inference_mode():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        x = torch.as_tensor(images, device=dev)
        cams_t = torch.as_tensor(cams, device=dev)
        ds_t, di_t = torch.as_tensor(ds, device=dev), torch.as_tensor(di, device=dev)
        from mvsnet_tpu_torch.ops.cost_volume import plane_sweep_cost_volume
        from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map
        ev[0].record()
        ref_f, view_f = model.extract_features(x)
        ev[1].record()
        h = homographies_for_views(cams_t, 192, ds_t, di_t)
        ev[2].record()
        cost = plane_sweep_cost_volume(ref_f, view_f, h)
        ev[3].record()
        reg = model.regnet(cost)[..., 0].float()
        ev[4].record()
        soft_argmin_prob_map(reg, ds_t, di_t, 192)
        ev[5].record()
        torch.cuda.synchronize()
        names = ["feature_net", "homographies", "cost_volume", "regnet", "depth_tail"]
        stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    print("  stages (ms, CUDA events, one request): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # one more request under torch.profiler: device time by kernel, idle share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(images, cams, ds, di, fetch=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in dev_events)
    if busy_us > 0:
        print(f"  profiled request: wall {wall_us / 1e3:.3f} ms, device busy "
              f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}; "
              f"top device time:")
        for e in sorted(dev_events, key=lambda e: -e.device_time_total)[:12]:
            print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<3d} {e.key[:90]}")
    else:
        print("  profiled request: the profiler saw no device time (not measured)")

    # ---- 5. end to end: card kernels vs CPU plain path, float32
    small = ModelConfig(view_num=3, max_d=32, width=320, height=256,
                        network_mode="normal", compute_dtype="float32")
    s_images, s_cams = scene(1, 3, 256, 320, 32, seed=1)
    s_ds, s_di, _, _ = depth_params_from_cams(s_cams)
    d_gpu, p_gpu, _ = Predictor(small, seed=1, device=dev).predict(
        s_images, s_cams, s_ds, s_di)
    d_cpu, p_cpu, _ = Predictor(small, seed=1, device="cpu").predict(
        s_images, s_cams, s_ds, s_di)
    d_err = float(np.abs(d_gpu - d_cpu).max())
    p_err = float(np.abs(p_gpu - p_cpu).max())
    ok = (np.isfinite(d_gpu).all() and np.isfinite(p_gpu).all()
          and d_err <= E2E_DEPTH_ATOL and p_err <= E2E_PROB_ATOL)
    print(f"end to end 320x256 D=32 normal f32, card vs CPU: depth max abs err "
          f"{d_err:.3e} (bound {E2E_DEPTH_ATOL:g}), prob max abs err {p_err:.3e} "
          f"(bound {E2E_PROB_ATOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        return 1

    # ---- 6. records
    out = []
    for c in cases:
        r = records[(c["name"], "bfloat16")]
        out.append(dict(name=c["name"], route="cuda", source=c["source"],
                        replaces=c["replaces"],
                        launches=run_launches[{sweep: "cost_volume", conv: "conv",
                                               deconv: "deconv"}[c["mod"]]],
                        **r))
    print(json.dumps({"kernels": out}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
