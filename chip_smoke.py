"""Drive the PyTorch/CUDA port (`mvsnet_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --multi    # phases 1, 2 and 8 only (several cards)

Phases, each of which fails the script (non-zero exit, no result line):
  1. the card's name and power limit; exits at once without CUDA;
  2. builds the CUDA kernels from `mvsnet_tpu_torch/csrc` with nvcc (sm_90a)
     and prints each kernel's registers, stack and spills;
  3. holds every kernel against its plain PyTorch version on the card at
     the main paths' shapes, in float32 and bfloat16, then times kernel,
     plain version and the one PyTorch library call for the same function
     (CUDA events, after a warm-up) beside the least time the card could
     take (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16 or 67 TFLOP/s
     float32, whichever is larger): the forward kernels at the inference
     point, the backward kernels (warp, transposed warp, weight gradient,
     the 5x5 transposed conv) at the training point; every bf16 conv,
     transposed-conv and weight-gradient row of an editioned kernel is
     timed in both editions, in turns (tc, simt, simt, tc); the transposed
     warp is called twice on the same inputs, which must agree bit for bit,
     and so must two calls of the cost volume's backward at the training
     point (bf16);
  4. inference: `Predictor` at 1152x864, D=192, 3 views, "normal",
     bfloat16, seeded weights, answers 3 requests; launch counts per
     request are asserted (cost volume 1, conv 36, deconv 7), then one more
     request is timed stage by stage and one is profiled;
  5. inference end to end at 320x256, D=32, "normal", float32: the card's
     kernel path against the CPU's plain path with the same weights and
     inputs;
  6. training: `make_train_step` at 640x480, D=192, 3 views, "normal",
     bfloat16 with float32 parameters, RMSprop, power + gradient loss,
     seeded weights and a synthetic scene, takes 3 steps; launch counts per
     step, and the weight gradient's editions (tc 41, simt 2), are asserted
     against counts derived from the model, losses and gradients must be
     finite; then one step is timed stage by stage
     (forward, backward, optimizer) and one is profiled;
  7. one float32 train step at 128x128, D=16, "normal", norms perturbed
     from the identity: the card's kernels against the CPU's plain path
     (loss, every gradient, the batch-norm running statistics), and two
     such card steps against each other, bit for bit;
  8. multi-GPU serving and training (`mvsnet_tpu_torch/parallel/`):
     a. the row- and depth-sliced cost kernel K1s on every block of 8b's
        serving mesh and of the (1,4,1) and (1,2,2) meshes at the
        inference point, f32 and bf16, stitched and held against one K1
        launch bit for bit; each mesh's last block against its plain
        version and timed beside its bound (the record's numbers are
        those of 8b's mesh, whose blocks the latency requests launch);
     b. the single-card `Predictor` on a batch of maps against one call
        per map, bf16 and float32: float32 within phase 5's bounds, and
        the first module whose output depends on the batch named; then
        ranks started with `parallel.launch.spawn`: with two or more
        cards, one NCCL rank per card (2 or 4); with one card, two ranks
        on it over gloo with host staging. Each rank's default `Predictor`
        answers 3 latency requests (B=1: K1s, the depth-sharded U-Net) and
        3 throughput requests (B=n) at phase 4's point; depth and prob are
        held against phase 4's single-card `Predictor`, one call per map
        as each rank makes it (phase 5's bounds)
        and the launch counts per rank asserted (K1s 1 and K1 0 per
        latency request, K1 1 per throughput map); one latency request is
        timed stage by stage, its halo exchanges alone, and one profiled;
     c. one float32 `make_sharded_train_step` on two data ranks at 128x128,
        D=16, B=2 against the single-card step (phase 7's bounds).
The last lines are the kernels' JSON record (launches from the training
run of phase 6; K1s's from the latency requests of phase 8, summed over
ranks), the card's name and power limit, and {"ok": true, "device":
{...}}.
"""

import dataclasses
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
EXPECTED_LAUNCHES = {"cost_volume": 1, "cost_volume_sharded": 0, "conv": 36, "deconv": 7,
                     "warp": 0, "warp_transpose": 0, "wgrad": 0}
# per bf16 request: every conv and deconv on the tensor cores but the two
# convs on the 3-channel images (2dconv1_0, 2dconv0_1)
EXPECTED_EDITIONS = {"conv": {"tc": 34, "simt": 2}, "deconv": {"tc": 7, "simt": 0},
                     "wgrad": {"tc": 0, "simt": 0}}
SIMT_LAYERS = {"feature_net.2dconv1_0.conv", "feature_net.2dconv0_1.conv"}
# one float32 train step at 128x128, D=16, card kernels vs the CPU's plain
# path. The forward is well conditioned: loss and batch-norm statistics to
# 1e-4. The gradients are not: with every kernel swapped for its plain
# version, the same PyTorch step on the card and on the CPU differs by
# 6.2e-3 in the norm of all gradients and by 2.5e-2 of the worst leaf's
# largest entry (on the CPU alone, float64 convs or a 1e-7 jiggle of the
# homographies move them by up to 3e-3). So gradients are held to 2e-2 in
# the global norm and to 1e-1 of each leaf's largest entry; a wrong kernel
# moves the leaves it feeds by order 1. Two runs on the card are equal bit
# for bit, and phase 7 gates that: every kernel of the step sums in a fixed
# order (a scatter form of the transposed warp, adding with atomics, made
# them differ by 2e-6).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_GLOBAL_TOL = 2e-2   # ||g_card - g_cpu|| / ||g_cpu|| over all leaves
TRAIN_GRAD_TOL = 1e-1          # of each gradient leaf's largest entry
TRAIN_STATS_TOL = 1e-4         # of max(1, each statistic's largest entry)


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


def train_scene(H, W, D, seed):
    """A synthetic training batch as bench.py:186-198 makes it: seeded
    images and cams (`scene`) and a ground-truth depth map, uniform over
    the first 191 planes, at the cost-volume resolution."""
    images, cams = scene(1, 3, H, W, D, seed)
    rng = np.random.default_rng(seed + 100)
    start, interval = float(cams[0, 0, 1, 3, 0]), float(cams[0, 0, 1, 3, 1])
    gt = rng.uniform(start, start + 190 * interval, (1, H // 4, W // 4, 1)).astype(np.float32)
    return images, cams, gt, gt


def expected_train_launches(model, cfg, h, w):
    """Kernel launches of one train step (B = 1), derived from the model:
    every conv and transposed conv runs forward once and has one weight
    gradient; every conv but the two on the images (2dconv1_0 and 2dconv0_1
    take the images, which need no gradient) has an input gradient, on the
    conv kernel at stride 1 and on the transposed-conv kernel at stride 2;
    every transposed conv's input gradient is a stride-2 conv; the cost
    volume runs K1 forward, and K2 and K3 once per source view and depth
    chunk backward."""
    from mvsnet_tpu_torch.models.layers import Conv, Deconv
    from mvsnet_tpu_torch.ops.cost_volume import ACC_LIMIT_BYTES

    fn = model.feature_net._modules
    image_convs = {fn["2dconv1_0"].conv, fn["2dconv0_1"].conv}
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    deconvs = [m for m in model.modules() if isinstance(m, Deconv)]
    dx_s1 = sum(1 for c in convs if c.stride == 1 and c not in image_convs)
    dx_s2 = sum(1 for c in convs if c.stride == 2 and c not in image_convs)
    V, C = cfg.view_num, cfg.feature_channels
    chunks = max(1, -(-(V * cfg.max_d * h * w * C * 4) // ACC_LIMIT_BYTES))
    return {"cost_volume": 1, "cost_volume_sharded": 0,
            "conv": len(convs) + dx_s1 + len(deconvs),
            "deconv": len(deconvs) + dx_s2, "warp": (V - 1) * chunks,
            "warp_transpose": (V - 1) * chunks, "wgrad": len(convs) + len(deconvs)}


def expected_wgrad_editions(model, dtype):
    """Weight-gradient launches of one train step by edition: a conv's dk
    is wgrad(x, g) on (Cin, Cout), a transposed conv's wgrad(g, x) on (Cout,
    Cin); each runs the edition `wgrad.pick_edition` gives its channels
    (bf16: "simt" only for the two image convs' Cin = 3)."""
    from mvsnet_tpu_torch.models.layers import Conv, Deconv
    from mvsnet_tpu_torch.ops.kernels import wgrad

    counts = {e: 0 for e in wgrad.EDITIONS}
    for m in model.modules():
        if isinstance(m, (Conv, Deconv)):
            cin, cout = m.kernel.shape[-2:]
            if isinstance(m, Deconv):
                cin, cout = cout, cin
            counts[wgrad.pick_edition(dtype, cin, cout)] += 1
    return counts


def perturb_norms(model, seed):
    """Non-identity norm parameters and running statistics, as a trained
    model has them. With the identity init, some gradient leaves are sums
    of terms that nearly cancel: in the float32 step of phase 7, computing
    only the convs in float64 moves them by up to 4 % of their largest
    entry, against under 1e-4 with these norms (CPU runs of the plain
    path)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith(("scale", "var")):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith((".gn.bias", ".bn.bias", "mean")):
                t.copy_(0.2 * torch.randn(t.shape, generator=g))


def layer_bound_ms(kind, x, w, out, stride=1, los=None):
    """The least time of one conv or deconv call: its bytes (input, weights
    and output once each) at 3.35 TB/s or its operations on the taps inside
    the input at 989 TFLOP/s (bf16), whichever is larger."""
    from mvsnet_tpu_torch.ops.kernels.conv import same_pads

    k = w.shape[0]
    cin, cout = x.shape[-1], out.shape[-1]
    ins, outs = x.shape[1:-1], out.shape[1:-1]
    if kind == "conv":
        taps = [valid_taps(n, k, stride, lo, m) for n, m, lo in
                zip(ins, outs, los or [same_pads(n, k, stride)[0] for n in ins])]
    else:
        taps = [sum(1 for o in range(m) for t in range(k)
                    if (o + lo - t) % 2 == 0 and 0 <= (o + lo - t) // 2 < n)
                for n, m, lo in zip(ins, outs, los)]
    ops = 2 * cin * cout * x.shape[0] * int(np.prod(taps))
    n_bytes = (x.numel() + w.numel() + out.numel()) * x.element_size()
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[x.dtype]) * 1e3


def layer_times(smi, predictor, request):
    """One steady request with every conv and deconv call timed by CUDA
    events around the wrapper (launch included), named by module: one line
    per layer (name, input shape, edition, ms, bound ms), then the sums per
    source and edition. Returns whether every layer ran the edition the
    rule gives it (simt only for the two convs on the images)."""
    from mvsnet_tpu_torch.models.layers import Conv, Deconv
    from mvsnet_tpu_torch.ops.kernels import conv, deconv

    model = predictor.model
    current, calls = [None], []
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: current.__setitem__(0, name))
             for name, m in model.named_modules() if isinstance(m, (Conv, Deconv))]

    def timed(kind, fn):
        mod = conv if kind == "conv" else deconv

        def call(x, kernel, *args, **kwargs):
            before = dict(mod.launches_by_edition)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x, kernel, *args, **kwargs)
            end.record()
            ed = next(e for e, n in mod.launches_by_edition.items() if n != before[e])
            calls.append((current[0], kind, tuple(x.shape), tuple(kernel.shape), ed, start, end,
                          (x, kernel, out, args, kwargs)))
            return out
        return call

    real = conv.conv, deconv.deconv
    conv.conv, deconv.deconv = timed("conv", real[0]), timed("deconv", real[1])
    try:
        predictor.predict(*request, fetch=False)
        torch.cuda.synchronize()
    finally:
        conv.conv, deconv.deconv = real
        for h in hooks:
            h.remove()
    print(f"  layers of one request (ms by CUDA events around each wrapper call; bound as "
          f"phase 3) [{smi}]:")
    sums, ok = {}, True
    for name, kind, xs, ws, ed, start, end, (x, w, out, args, kwargs) in calls:
        ms = start.elapsed_time(end)
        if kind == "conv":
            stride = args[1] if len(args) > 1 else kwargs.get("stride", 1)
            bound = layer_bound_ms(kind, x, w, out, stride)
        else:
            bound = layer_bound_ms(kind, x, w, out, los=[0] * (x.ndim - 2))
        src = f"{kind}.cu {ed}"
        n, t, b = sums.get(src, (0, 0.0, 0.0))
        sums[src] = (n + 1, t + ms, b + bound)
        want = "simt" if name in SIMT_LAYERS else "tc"
        ok = ok and ed == want
        print(f"    {name:32s} {kind:6s} in {xs} k {ws} {ed:4s} {ms:8.4f} ms  bound "
              f"{bound:.4f} ms{'' if ed == want else '  WRONG EDITION'}")
    print("  per source and edition (launches, ms, bound ms): " + "; ".join(
        f"{k} {n}, {t:.4f}, {b:.4f}" for k, (n, t, b) in sorted(sums.items())))
    return ok and len(calls) == 43


def profile_device(fn):
    """Wall ms, device-busy ms and the top kernels of one call of fn under
    torch.profiler; busy is None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels and copies; a user annotation (the optimizer's
    # "Optimizer.step#..." range) spans kernels already counted
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time_total for e in dev_events) / 1e3
    return wall_ms, (busy_ms if busy_ms > 0 else None), dev_events


# the port's kernels by source and pass, as the profiler names them
KERNEL_FAMILIES = (("wgrad tc", "wgrad_tc_kernel"), ("wgrad simt", "wgrad_partial_kernel"),
                   ("wgrad reduce", "wgrad_reduce_kernel"), ("cost_volume", "cost_volume_kernel"),
                   ("conv/deconv tc", "tc_conv_kernel"), ("conv simt", "::conv_kernel"),
                   ("warp", "::warp_kernel"), ("warp transpose", "warp_transpose_kernel"),
                   ("warp transpose plan", "::plan_kernel"),
                   ("warp transpose run sum", "segment_sum_kernel"))


def print_profile(what, wall_ms, busy_ms, events):
    if busy_ms is None:
        print(f"  profiled {what}: the profiler saw no device time (not measured)")
        return
    print(f"  profiled {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}; top device time:")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:14]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    sums = []
    for family, pattern in KERNEL_FAMILIES:
        hits = [e for e in events if pattern in e.key]
        if hits:
            sums.append(f"{family} {sum(e.device_time_total for e in hits) / 1e3:.3f} ms "
                        f"x{sum(e.count for e in hits)}")
    print("    by kernel family: " + "; ".join(sums))


def step_errors(got, ref):
    """(loss rel err, global gradient err, worst leaf, its err, running
    statistics err) of one train step's (loss, grads, buffers) against
    another's, as phase 7 bounds them."""
    (l_got, g_got, b_got), (l_ref, g_ref, b_ref) = got, ref
    loss_err = abs(l_got - l_ref) / abs(l_ref)
    leaf_err = {n: float(np.abs(g_got[n] - g).max()) / max(float(np.abs(g).max()), 1e-12)
                for n, g in g_ref.items()}
    worst = max(leaf_err, key=leaf_err.get)
    global_err = float(np.sqrt(sum(float(((g_got[n] - g) ** 2).sum()) for n, g in g_ref.items())
                               / sum(float((g ** 2).sum()) for g in g_ref.values())))
    stats_err = max(float(np.abs(b_got[n] - b).max()) / max(1.0, float(np.abs(b).max()))
                    for n, b in b_ref.items())
    ok = (np.isfinite(l_got) and loss_err <= TRAIN_LOSS_RTOL
          and global_err <= TRAIN_GRAD_GLOBAL_TOL and leaf_err[worst] <= TRAIN_GRAD_TOL
          and stats_err <= TRAIN_STATS_TOL)
    text = (f"loss rel err {loss_err:.3e} (bound {TRAIN_LOSS_RTOL:g}), gradients "
            f"{global_err:.3e} in the global norm (bound {TRAIN_GRAD_GLOBAL_TOL:g}), worst "
            f"leaf {worst} {leaf_err[worst]:.3e} of its max (bound {TRAIN_GRAD_TOL:g}), "
            f"running stats {stats_err:.3e} (bound {TRAIN_STATS_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
    return ok, text


def backward_repeat(smi, randn, homs, H=120, W=160, C=32):
    """Two calls of `ops/cost_volume.cost_volume_backward` at the training
    point (bf16 features, homs (2, D, 3, 3)) on the same inputs: K2, PyTorch's
    elementwise chain and K3 in a fixed order, so equal bit for bit. Returns
    the failures."""
    from mvsnet_tpu_torch.ops.cost_volume import cost_volume_backward

    D = homs.shape[1]
    ref, views = randn((H, W, C), torch.bfloat16), randn((2, H, W, C), torch.bfloat16)
    g = randn((D, H, W, C), torch.bfloat16)
    first = cost_volume_backward(ref, views, homs, g)
    second = cost_volume_backward(ref, views, homs, g)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"  cost_volume_backward bf16 ({D},{H},{W},{C}), V=3: two calls equal bit for bit: "
          f"{same} [{smi}]")
    del ref, views, g, first, second
    torch.cuda.empty_cache()
    return [] if same else ["cost_volume_backward: two calls differ"]


def repeat_difference(a, b):
    """The largest absolute difference between two train steps' (loss,
    grads, buffers), and the first leaf (loss, then gradients and buffers
    in the model's order) where they differ, or None."""
    (l_a, g_a, b_a), (l_b, g_b, b_b) = a, b
    diffs = [("loss", abs(l_a - l_b))]
    diffs += [(f"grad {n}", float(np.abs(g_a[n] - g_b[n]).max())) for n in g_a]
    diffs += [(f"buffer {n}", float(np.abs(b_a[n] - b_b[n]).max())) for n in b_a]
    first = next((n for n, d in diffs if d != 0), None)
    return max(d for _, d in diffs), first


def serving_setup():
    """(backend, ranks, serving mesh) of phase 8b: with two or more cards one
    NCCL rank per card on 2 or 4 of them; with one, two gloo-cuda ranks on
    it. The
    mesh is the default one of `Predictor` in such a process group."""
    from mvsnet_tpu_torch.parallel.mesh import factorize_devices

    cards = torch.cuda.device_count()
    backend, n = ("nccl", 4 if cards >= 4 else 2) if cards >= 2 else ("gloo-cuda", 2)
    da, de, sp = factorize_devices(n)
    return backend, n, (1, da * de, sp)


def phase8_sharded_cost(smi, randn, homs, serve_mesh, H=216, W=288, C=32):
    """8a: K1s on every block of the serving mesh of 8b and of the (1,4,1)
    and (1,2,2) meshes at the inference point (features H x W x C, homs
    (2, D, 3, 3)), stitched against one K1 launch bit for bit, and the last
    block of each against its plain version, timed. Returns the kernel
    record of the serving mesh's bf16 block, the one 8b launches, or None
    on failure."""
    from mvsnet_tpu_torch.ops.kernels import sweep

    D = homs.shape[1]
    print(f"phase 8a: K1s blocks of the cost volume at 1152x864, D=192, V=3 (features "
          f"{H}x{W}x{C}) stitched against one K1 launch (bit for bit), the last block "
          f"against its plain version (tol as phase 3) [{smi}]")
    record, ok = None, True
    meshes = list(dict.fromkeys([serve_mesh[1:], (4, 1), (2, 2)]))
    for dtype in (torch.float32, torch.bfloat16):
        ref, views = randn((H, W, C), dtype), randn((2, H, W, C), dtype)
        whole = sweep.cost_volume(ref, views, homs)
        for dp, sp in meshes:
            Dl, hl = D // dp, H // sp

            def block(d, s, ref=ref, views=views, Dl=Dl, hl=hl):
                return sweep.cost_volume(ref[s * hl:(s + 1) * hl], views,
                                         homs[:, d * Dl:(d + 1) * Dl], row_offset=s * hl)
            stitched = torch.cat([torch.cat([block(d, s) for s in range(sp)], dim=1)
                                  for d in range(dp)], dim=0)
            equal = torch.equal(stitched, whole)
            del stitched
            r0 = (sp - 1) * hl                 # the last block: far edge in depth and rows
            args = (ref[r0:].contiguous(), views, homs[:, D - Dl:].contiguous())
            got = sweep.cost_volume(*args, row_offset=r0)
            want = sweep.cost_volume_plain(*args, row_offset=r0)
            got, want = got.float(), want.float()
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            close = bool(torch.isfinite(got).all()) and err <= TOL[dtype] * max(1.0, scale)
            del got, want
            ms = cuda_time_ms(lambda: sweep.cost_volume(*args, row_offset=r0))
            plain_ms = cuda_time_ms(lambda: sweep.cost_volume_plain(*args, row_offset=r0),
                                    max_iters=10)
            it = torch.tensor([], dtype=dtype).element_size()
            n_out = Dl * hl * W * C
            n_bytes = (hl * W * C + 2 * H * W * C + n_out) * it + args[2].numel() * 4
            n_ops = n_out * (12 * 2 + 4) + Dl * hl * W * 2 * 25
            bound_ms, bound_by = max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                                     (n_ops / PEAK_OPS[dtype] * 1e3, "operations"))
            tag = str(dtype).replace("torch.", "")
            serves = " (8b's)" if (dp, sp) == serve_mesh[1:] else ""
            print(f"  mesh (1,{dp},{sp}){serves} {tag:8s} block ({Dl},{hl},{W},{C}): stitched == K1 "
                  f"{equal}; block max_abs_err {err:.3e} {'ok' if close else 'FAIL'} | kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{n_bytes / 1e6:.1f} MB) [{smi}]")
            ok = ok and equal and close
            if dtype == torch.bfloat16 and (dp, sp) == serve_mesh[1:]:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=None)
        del whole, ref, views
        torch.cuda.empty_cache()
    if not ok:
        print("phase 8a FAILED")
        return None
    return record


def batch_divergence(model, inputs, n):
    """The first module, in call order, whose output differs between one
    eval forward on a batch of n maps and n forwards on one map each, from
    forward hooks on every leaf module: (name, whether its input was equal,
    elements that differ, elements, max abs difference), or None when every
    output is equal."""
    seen = {}

    def hook(name):
        def record(_module, args, out):
            seen.setdefault(name, []).append((args[0], out))
        return record
    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()
               if not list(m.children())]
    try:
        with torch.inference_mode():
            model.forward_3dcnn(*inputs)
            for i in range(n):
                model.forward_3dcnn(*(a[i:i + 1] for a in inputs))
    finally:
        for h in handles:
            h.remove()
    for name, calls in seen.items():
        (x_b, y_b), single = calls[0], calls[1:]
        y_s = torch.cat([y for _, y in single])
        if not torch.equal(y_b, y_s):
            diff = (y_b.float() - y_s.float()).abs()
            return (name, torch.equal(x_b, torch.cat([x for x, _ in single])),
                    int((diff > 0).sum()), diff.numel(), diff.max().item())
    return None


def batch_witness(smi, dev, cfg, batch_in, n):
    """The single-card `Predictor` on a batch of n maps against one call per
    map, in bf16 and float32 at the inference point; the float32 answers
    must agree within phase 5's bounds (maps that mixed would not), and the
    first module whose output depends on the batch is named. Returns
    whether the float32 gate held."""
    from mvsnet_tpu_torch.predict import Predictor

    ok = True
    for dtype in ("bfloat16", "float32"):
        predictor = Predictor(dataclasses.replace(cfg, compute_dtype=dtype), seed=0, device=dev)
        batch = predictor.predict(*batch_in)[:2]
        single = [predictor.predict(*(a[i:i + 1] for a in batch_in))[:2] for i in range(n)]
        d_err, p_err = (float(np.abs(b - np.concatenate(s)).max())
                        for b, s in zip(batch, zip(*single)))
        first = batch_divergence(predictor.model, tuple(
            torch.as_tensor(a, device=dev) for a in batch_in[:4]), n)
        where = ("every module's output is equal" if first is None else
                 f"the first module whose output differs is {first[0]} (its input "
                 f"{'equal' if first[1] else 'differs'}): {first[2]} of {first[3]} elements, "
                 f"max abs diff {first[4]:.3e}")
        gate = ""
        if dtype == "float32":
            good = d_err <= E2E_DEPTH_ATOL and p_err <= E2E_PROB_ATOL
            ok = ok and good
            gate = (f" (bounds {E2E_DEPTH_ATOL:g} / {E2E_PROB_ATOL:g}) "
                    f"{'ok' if good else 'FAIL'}")
        print(f"  single-card Predictor, {n} maps as one batch vs one call per map, {dtype}: "
              f"depth max abs diff {d_err:.3e}, prob {p_err:.3e}{gate}; {where} [{smi}]")
        del predictor
        torch.cuda.empty_cache()
    return ok


def phase8_ranks(smi, dev, serve_in, backend, n):
    """8b and 8c: serving in both regimes and one sharded train step on
    several ranks (`phase8_rank`), against the single-card `Predictor` and
    train step on the same inputs. Returns the K1s launches of the latency
    requests summed over ranks, or None on failure."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.parallel.launch import spawn
    from mvsnet_tpu_torch.predict import Predictor, depth_params_from_cams

    where = (f"{n} NCCL ranks, one per card" if backend == "nccl" else
             "2 ranks on one card over gloo, collectives staged through host memory")
    print(f"phase 8b/8c: {where} [{smi}]")

    # references: phase 4's single-card Predictor, phase 7's single-card step
    cfg = ModelConfig(view_num=3, max_d=192, width=1152, height=864,
                      network_mode="normal", compute_dtype="bfloat16")
    b_images, b_cams = scene(n, 3, 864, 1152, 192, seed=5)
    b_ds, b_di, _, b_de = depth_params_from_cams(b_cams)
    batch_in = (b_images, b_cams, b_ds, b_di, b_de)
    predictor = Predictor(cfg, seed=0, device=dev)
    # the throughput reference runs each map alone, as its rank does: in
    # bf16 one call on a batch of n differs from it (`batch_witness`)
    per_map = [predictor.predict(*(a[i:i + 1] for a in batch_in))[:2] for i in range(n)]
    ref = {"latency": predictor.predict(*serve_in)[:2],
           "throughput": tuple(np.concatenate(p, axis=0) for p in zip(*per_map))}
    del predictor
    ok = batch_witness(smi, dev, cfg, batch_in, n)
    s_cfg = ModelConfig(view_num=3, max_d=16, width=128, height=128,
                        network_mode="normal", compute_dtype="float32")
    scenes = [train_scene(128, 128, 16, seed) for seed in (3, 8)]
    t_batch = tuple(np.concatenate(parts, axis=0) for parts in zip(*scenes))
    m = MVSNet(s_cfg, seed=3)
    perturb_norms(m, seed=4)
    st = train_lib.create_train_state(m, s_cfg, TrainConfig(), device=dev)
    _, met = train_lib.make_train_step(m, s_cfg, TrainConfig())(st, t_batch)
    ref_step = (met["loss"].item(), {k: p.grad.cpu().numpy() for k, p in m.named_parameters()},
                {k: b.cpu().numpy() for k, b in m.named_buffers()})
    del m, st, met
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    results = spawn(phase8_rank, n, backend, backend, serve_in, batch_in, t_batch)
    print(f"  ranks started, served, trained and joined in {time.perf_counter() - t0:.1f} s; "
          f"serving mesh {results[0]['mesh']}, devices {[r['device'] for r in results]}")
    expected = {"latency": {"cost_volume_sharded": 1, "cost_volume": 0},
                "throughput": {"cost_volume_sharded": 0, "cost_volume": 1}}
    for regime, B in (("latency", 1), ("throughput", n)):
        d_err = max(float(np.abs(r[regime]["depth"] - ref[regime][0]).max()) for r in results)
        p_err = max(float(np.abs(r[regime]["prob"] - ref[regime][1]).max()) for r in results)
        counts_ok = all(all(c[k] == v for k, v in expected[regime].items())
                        for r in results for c in r[regime]["counts"])
        good = d_err <= E2E_DEPTH_ATOL and p_err <= E2E_PROB_ATOL and counts_ok
        ok = ok and good
        walls = "; ".join(f"rank {i}: " + ", ".join(f"{w:.2f}" for w in r[regime]["walls"])
                          for i, r in enumerate(results))
        print(f"  {regime} regime, B={B}, 1152x864, D=192, V=3, normal, bf16: wall ms per "
              f"request {walls} (the first includes set-up); vs the single-card Predictor: "
              f"depth max abs err {d_err:.3e} (bound {E2E_DEPTH_ATOL:g}), prob {p_err:.3e} "
              f"(bound {E2E_PROB_ATOL:g}) {'ok' if good else 'FAIL'} [{smi}]")
        print(f"    launches per request, rank 0: {results[0][regime]['counts'][0]}; expected "
              f"per rank {expected[regime]} {'ok' if counts_ok else 'FAIL'}")
    for i, r in enumerate(results):
        wall, busy = r["profile"]
        busy_text = ("not measured (the profiler saw no device time)" if busy is None else
                     f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}")
        print(f"  latency request, rank {i}, stages (ms, host clock after a synchronize): "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["stages"].items())
              + f"; halo exchanges {r['halo_count']} taking {r['halo_ms']:.3f} ms (each "
              f"timed alone); profiled request wall {wall:.3f} ms, {busy_text} [{smi}]")
    for i, r in enumerate(results):
        t = r["train"]
        good, text = step_errors((t["loss"], t["grads"], t["buffers"]), ref_step)
        same = all(np.array_equal(b, results[0]["train"]["buffers"][k])
                   for k, b in t["buffers"].items())
        ok = ok and good and same
        print(f"  sharded train step, rank {i}, mesh {t['mesh']}, 128x128 D=16 B=2 normal f32, "
              f"vs the single-card step: {text}; running stats equal to rank 0's: {same}")
    if not ok:
        print("phase 8 FAILED")
        return None
    return sum(r["latency"]["total"]["cost_volume_sharded"] for r in results)


def phase8_rank(backend, serve_in, batch_in, train_batch):
    """One rank of phase 8 (started by `parallel.launch.spawn`): serving in
    the latency (B=1) and throughput (B=n) regimes through the default
    multi-device `Predictor`, then one sharded f32 train step. Returns
    numpy results, launch counts and timings."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.parallel import halo
    from mvsnet_tpu_torch.parallel.infer_step import LATENCY_STAGES, latency_forward
    from mvsnet_tpu_torch.parallel.mesh import make_mesh
    from mvsnet_tpu_torch.parallel.train_step import make_sharded_train_step
    from mvsnet_tpu_torch.predict import Predictor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(view_num=3, max_d=192, width=1152, height=864,
                      network_mode="normal", compute_dtype="bfloat16")
    predictor = Predictor(cfg, seed=0)        # the default mesh of this process group
    mesh = predictor.mesh
    out = {"mesh": mesh.shape, "device": str(mesh.device)}

    def serve(inputs, key):
        kernels.reset_launch_counts()
        walls, counts = [], []
        for _ in range(3):
            before = kernels.launch_counts()
            torch.distributed.barrier()
            t0 = time.perf_counter()
            depth, prob, _ = predictor.predict(*inputs, fetch=False)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            after = kernels.launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
        out[key] = dict(walls=walls, counts=counts, total=kernels.launch_counts(),
                        depth=depth.cpu().numpy(), prob=prob.cpu().numpy())

    serve(serve_in, "latency")
    serve(batch_in, "throughput")

    # one latency request stage by stage: host clock after a synchronize
    model = predictor.model
    # the graph's inputs: depth_end is the Predictor's alone
    args = tuple(torch.as_tensor(a, device=mesh.device) for a in serve_in[:4])
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    with torch.inference_mode():
        torch.distributed.barrier()
        mark("start")
        latency_forward(model, mesh, *args, on_stage=mark)
        out["stages"] = {name: (t - marks[i][1]) * 1e3
                         for i, (name, t) in enumerate(marks[1:])}
        assert tuple(out["stages"]) == LATENCY_STAGES
        # the halo exchanges of one request, each timed alone
        exchange, spent = halo.exchange, []

        def timed_exchange(x, m):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = exchange(x, m)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0) * 1e3)
            return r
        halo.exchange = timed_exchange
        try:
            latency_forward(model, mesh, *args)
        finally:
            halo.exchange = exchange
        out["halo_ms"], out["halo_count"] = sum(spent), len(spent)
    torch.distributed.barrier()
    out["profile"] = profile_device(lambda: predictor.predict(*serve_in, fetch=False))[:2]
    del predictor, model, args
    torch.cuda.empty_cache()

    # ---- 8c: one sharded f32 train step, two data ranks
    s_cfg = ModelConfig(view_num=3, max_d=16, width=128, height=128,
                        network_mode="normal", compute_dtype="float32")
    t_mesh = make_mesh(shape=(2, mesh.size // 2, 1), backend=backend)
    m = MVSNet(s_cfg, seed=3)
    perturb_norms(m, seed=4)
    tcfg = TrainConfig()
    state = train_lib.create_train_state(m, s_cfg, tcfg, device=t_mesh.device)
    _, met = make_sharded_train_step(m, s_cfg, tcfg, t_mesh)(state, train_batch)
    out["train"] = dict(mesh=t_mesh.shape, loss=met["loss"].item(),
                        grads={n: p.grad.cpu().numpy() for n, p in m.named_parameters()},
                        buffers={n: b.cpu().numpy() for n, b in m.named_buffers()})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    print(f"card: {smi}")
    torch.backends.cudnn.allow_tf32 = False          # float32 references stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.ops.geometry import homographies_for_views
    from mvsnet_tpu_torch.ops.kernels import _lib, conv, deconv, sweep, warp, wgrad
    from mvsnet_tpu_torch.predict import Predictor, depth_params_from_cams

    # ---- 2. build
    t0 = time.perf_counter()
    _lib.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_lib.SOURCES)} "
          f"(nvcc {' '.join(_lib.NVCC_FLAGS)})")
    summarize_build(_lib)

    # ---- 3. kernels against their plain versions at the main paths' shapes
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def homs_of(cams, D):
        ds, di, _, _ = depth_params_from_cams(cams)
        return homographies_for_views(torch.from_numpy(cams).to(dev), D,
                                      torch.from_numpy(ds).to(dev),
                                      torch.from_numpy(di).to(dev))[:, 0].contiguous()

    images, cams = scene(1, 3, 864, 1152, 192, seed=0)
    ds, di, _, de = depth_params_from_cams(cams)
    request = (images, cams, ds, di, de)
    homs = homs_of(cams, 192)
    # the training point: 640x480 images, features 160x120, D=192
    t_batch = train_scene(480, 640, 192, seed=2)
    t_homs = homs_of(t_batch[1], 192)
    if sys.argv[1:] == ["--multi"]:
        k1s = phase8(smi, dev, randn, homs, request)
        return 1 if k1s is None else report([k1s])
    cases = []     # one dict per kernel and shape

    def add_cost():
        def make(dtype):
            return (randn((216, 288, 32), dtype), randn((2, 216, 288, 32), dtype), homs)
        n_out = 192 * 216 * 288 * 32
        ops = n_out * (12 * 2 + 4) + 192 * 216 * 288 * 2 * 25
        cases.append(dict(
            name="cost_volume", counter="cost_volume", kernel=sweep.cost_volume,
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
            name=f"conv:{layer}", counter="conv",
            edition=lambda dtype: conv.pick_edition(dtype, cin, cout),
            kernel=lambda x, w, b, edition=None: conv.conv(x, w, b, stride, epilogue,
                                                           edition=edition),
            plain=lambda x, w, b: conv.conv_plain(x, w, b, stride, epilogue),
            library=library, library_inputs=library_inputs, make=make,
            bytes=lambda it: (int(np.prod(shape)) + k ** rank * cin * cout + n_out) * it,
            ops=2 * cin * cout * int(taps) * shape[0],
            source="mvsnet_tpu_torch/csrc/conv.cu", replaces=replaces))

    def add_deconv(layer, shape, cout, epilogue, replaces, k=3, out_spatial=None):
        """flax's k3 s2 transposed conv, or (k=5, out_spatial) the adjoint
        of a 5x5 stride-2 SAME conv of that output size."""
        cin = shape[-1]
        rank = len(shape) - 2
        outs = out_spatial or tuple(2 * n for n in shape[1:-1])
        los = [conv.same_pads(m, k, 2)[0] for m in outs] if out_spatial else [0] * rank

        def make(dtype):
            x = randn(shape, dtype)
            w = randn((k,) * rank + (cin, cout), dtype, (k * k * cin) ** -0.5)
            b = randn((cout,), torch.float32) if epilogue else None
            return x, w, b

        n_out = shape[0] * int(np.prod(outs)) * cout
        taps = int(np.prod([sum(1 for o in range(m) for t in range(k)
                                if (o + lo - t) % 2 == 0 and 0 <= (o + lo - t) // 2 < n)
                            for n, m, lo in zip(shape[1:-1], outs, los)]))

        def library(x, w, b):
            wt = w.flip(list(range(rank))).permute(rank, rank + 1, *range(rank))
            y = (F.conv_transpose3d if rank == 3 else F.conv_transpose2d)(
                x.movedim(-1, 1), wt, b, stride=2)
            return y[(..., *(slice(lo, lo + m) for lo, m in zip(los, outs)))]

        cases.append(dict(
            name=f"deconv:{layer}", counter="deconv",
            edition=lambda dtype: conv.pick_edition(dtype, cin, cout),
            kernel=lambda x, w, b, edition=None: deconv.deconv(x, w, b, epilogue, los, outs,
                                                               edition=edition),
            plain=lambda x, w, b: deconv.deconv_plain(x, w, b, epilogue, los, outs),
            library=library,
            library_inputs=lambda x, w, b: (x, w, None if b is None else b.to(x.dtype)),
            make=make,
            bytes=lambda it: (int(np.prod(shape)) + k ** rank * cin * cout + n_out) * it,
            ops=2 * cin * cout * taps * shape[0],
            source="mvsnet_tpu_torch/csrc/deconv.cu", replaces=replaces))

    def add_warp(hm, replaces):
        D, (H, W, C) = hm.shape[0], (120, 160, 32)
        # F.grid_sample on (1, C, H, W) at the same taps (align_corners=False:
        # pixel x sits at (2x + 1) / W - 1): a yardstick, it rounds otherwise
        from mvsnet_tpu_torch.ops.warp import projected_coords
        px, py = projected_coords(hm, H, W)
        grid = torch.stack([(2 * px + 1) / W - 1, (2 * py + 1) / H - 1], -1)
        grid = grid.reshape(1, D * H, W, 2)

        def make(dtype):
            return randn((H, W, C), dtype), hm

        cases.append(dict(
            name="warp", counter="warp", kernel=warp.warp_all_depths,
            plain=warp.warp_all_depths_plain,
            library=lambda img, _: F.grid_sample(img, grid.to(img.dtype), align_corners=False),
            library_inputs=lambda img, h: (img.movedim(-1, 0)[None].contiguous(), h),
            make=make, bytes=lambda it: (H * W * C + D * H * W * C) * it + hm.numel() * 4,
            ops=D * H * W * (C * 6 + 25), source="mvsnet_tpu_torch/csrc/warp.cu",
            replaces=replaces))

        def lib_t_inputs(g, h):
            inp = torch.zeros((1, C, H, W), dtype=g.dtype, device=dev, requires_grad=True)
            out = F.grid_sample(inp, grid.to(g.dtype), align_corners=False)
            gout = g.reshape(D, H, W, C).permute(3, 0, 1, 2).reshape(1, C, D * H, W)
            return out, inp, gout.contiguous()

        cases.append(dict(
            name="warp_transpose", counter="warp_transpose", kernel=warp.warp_transpose,
            plain=warp.warp_transpose_plain, f32_out=True, deterministic=True,
            # the train step's cotangents are float32 (ops/cost_volume.py)
            path_dtype=torch.float32,
            library=lambda out, inp, gout: torch.autograd.grad(out, inp, gout,
                                                               retain_graph=True),
            library_inputs=lib_t_inputs,
            make=lambda dtype: (randn((D, H, W, C), dtype), hm),
            bytes=lambda it: D * H * W * C * it + H * W * C * 4 + hm.numel() * 4,
            ops=D * H * W * (C * 8 + 25), source="mvsnet_tpu_torch/csrc/warp.cu",
            replaces="mvsnet_tpu/ops/pallas/sweep.py:1701"))

    def add_wgrad(layer, x_shape, g_shape, k, stride, replaces):
        rank = len(x_shape) - 2
        cin, cout = x_shape[-1], g_shape[-1]
        pads = [conv.same_pads(n, k, stride) for n in x_shape[1:-1]]
        taps = np.prod([valid_taps(n, k, stride, lo, out)
                        for n, (lo, _, out) in zip(x_shape[1:-1], pads)])
        fn = torch.nn.grad.conv3d_weight if rank == 3 else torch.nn.grad.conv2d_weight

        def library_inputs(x, g):
            # channels-first input with the SAME pad applied, untimed
            flat = [p for lo, hi, _ in reversed(pads) for p in (lo, hi)]
            return F.pad(x.movedim(-1, 1), flat).contiguous(), g.movedim(-1, 1).contiguous()

        cases.append(dict(
            name=f"wgrad:{layer}", counter="wgrad", f32_out=True,
            edition=lambda dtype: wgrad.pick_edition(dtype, cin, cout),
            kernel=lambda x, g, edition=None: wgrad.wgrad(x, g, (k,) * rank, stride,
                                                          edition=edition),
            plain=lambda x, g: wgrad.wgrad_plain(x, g, (k,) * rank, stride),
            library=lambda xp, gc: fn(xp, (cout, cin) + (k,) * rank, gc, stride=stride),
            library_inputs=library_inputs,
            make=lambda dtype: (randn(x_shape, dtype), randn(g_shape, dtype)),
            bytes=lambda it: (int(np.prod(x_shape)) + int(np.prod(g_shape))) * it
            + k ** rank * cin * cout * 4,
            ops=2 * cin * cout * int(taps) * x_shape[0],
            source="mvsnet_tpu_torch/csrc/wgrad.cu", replaces=replaces))

    c3, c2s1, c2s2 = ("mvsnet_tpu/ops/pallas/conv3d.py:974",
                      "mvsnet_tpu/ops/pallas/conv2d.py:871",
                      "mvsnet_tpu/ops/pallas/conv2d.py:578")
    wg1, wg2 = ("mvsnet_tpu/ops/pallas/conv3d.py:1185", "mvsnet_tpu/ops/pallas/conv3d.py:1318")
    add_cost()
    add_conv("3dconv0_1", (1, 192, 216, 288, 32), 3, 1, 8, True, c3)
    add_conv("3dconv1_0", (1, 192, 216, 288, 32), 3, 2, 16, True, c3)
    add_conv("3dconv3_1", (1, 24, 27, 36, 64), 3, 1, 64, True, c3)
    add_conv("3dconv6_2", (1, 192, 216, 288, 8), 3, 1, 1, False, c3)
    add_conv("2dconv0_1", (3, 864, 1152, 3), 3, 1, 8, False, c2s1)
    add_conv("2dconv1_0", (3, 864, 1152, 3), 3, 2, 16, False, c2s2)
    add_conv("2dconv4_1", (3, 54, 72, 128), 3, 1, 128, False, c2s1)
    add_conv("conv9_0", (3, 864, 1152, 8), 5, 2, 16, False, c2s2)
    add_deconv("3dconv6_0", (1, 96, 108, 144, 16), 8, True,
               "mvsnet_tpu/ops/pallas/deconv3d.py:194")
    add_deconv("3dconv4_0", (1, 24, 27, 36, 64), 32, True,
               "mvsnet_tpu/ops/pallas/deconv3d.py:194")
    add_deconv("2dconv8_0", (3, 432, 576, 16), 8, False,
               "mvsnet_tpu/ops/pallas/deconv2d.py:185")
    # the backward kernels at the training point (features 120x160, D=192)
    add_warp(t_homs[0], "mvsnet_tpu/ops/pallas/sweep.py:1599")
    add_wgrad("3dconv0_1", (1, 192, 120, 160, 32), (1, 192, 120, 160, 8), 3, 1, wg1)
    add_wgrad("3dconv1_0", (1, 192, 120, 160, 32), (1, 96, 60, 80, 16), 3, 2, wg2)
    # the transposed conv's dk: input and cotangent swapped (dq = q(dk))
    add_wgrad("3dconv6_0", (1, 192, 120, 160, 8), (1, 96, 60, 80, 16), 3, 2, wg2)
    add_wgrad("2dconv0_2", (3, 480, 640, 8), (3, 480, 640, 8), 3, 1, wg1)
    # Cout = 1, zero-padded to 8 columns in the tensor-core edition
    add_wgrad("3dconv6_2", (1, 192, 120, 160, 8), (1, 192, 120, 160, 1), 3, 1, wg1)
    # the layers whose partials split over row tiles and Cout slices
    add_wgrad("3dconv3_1", (1, 24, 15, 20, 64), (1, 24, 15, 20, 64), 3, 1, wg1)
    add_wgrad("2dconv4_1", (3, 30, 40, 128), (3, 30, 40, 128), 3, 1, wg1)
    add_wgrad("conv9_0", (3, 480, 640, 8), (3, 240, 320, 16), 5, 2, wg2)
    # conv9_0's input gradient: the 5x5 adjoint, low pad 1, at 480x640
    add_deconv("conv9_0_dx", (3, 240, 320, 16), 8, False,
               "mvsnet_tpu/ops/pallas/deconv2d.py:185", k=5, out_spatial=(480, 640))

    print("kernel phase: kernel vs plain version on the card "
          f"(pass: max abs err <= tol * max(1, max|plain|), tol {TOL[torch.float32]:g} "
          f"f32, {TOL[torch.bfloat16]:g} bf16; float32 outputs take the f32 tol); bf16 conv, "
          "deconv and wgrad rows also time the CUDA-core edition (simt) beside the tensor-core "
          "one (tc), in turns tc, simt, simt, tc")
    failures, records = [], {}
    for c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = c["make"](dtype)
            editioned = c["counter"] in kernels.EDITIONED
            before = kernels.launch_counts()[c["counter"]]
            ed_before = kernels.edition_counts().get(c["counter"])
            got = c["kernel"](*inputs)
            want = c["plain"](*inputs)
            torch.cuda.synchronize()
            if kernels.launch_counts()[c["counter"]] != before + 1:
                failures.append(f"{c['name']} {dtype}: the wrapper did not launch its kernel")
                continue
            tag = str(dtype).replace("torch.", "")
            if editioned:
                # the edition the module's rule gives these operands
                want_ed = c["edition"](dtype)
                ed_after = kernels.edition_counts()[c["counter"]]
                if ed_after[want_ed] != ed_before[want_ed] + 1:
                    failures.append(f"{c['name']} {tag}: ran {ed_before} -> {ed_after}, "
                                    f"not the {want_ed} edition")
            if got.shape != want.shape:
                failures.append(f"{c['name']} {dtype}: shape {tuple(got.shape)} != "
                                f"{tuple(want.shape)}")
                continue
            repeat_text = ""
            if c.get("deterministic"):
                # a fixed order of sums: a second call is equal bit for bit
                same = torch.equal(got, c["kernel"](*inputs))
                repeat_text = f"; a second call equal bit for bit: {same}"
                if not same:
                    failures.append(f"{c['name']} {dtype}: two calls differ")
            got, want = got.float(), want.float()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            tol = TOL[torch.float32 if c.get("f32_out") else dtype]
            ok = bool(torch.isfinite(got).all()) and err <= tol * max(1.0, scale)
            del got, want
            simt_text = ""
            if editioned and dtype == torch.bfloat16:
                turns = {"tc": [], "simt": []}
                for ed in ("tc", "simt", "simt", "tc"):
                    if ed == "tc" and want_ed != "tc":
                        continue
                    turns[ed].append(cuda_time_ms(lambda ed=ed: c["kernel"](*inputs, edition=ed)))
                ms = float(np.mean(turns[want_ed]))
                simt_text = (f"  [{want_ed} {', '.join(f'{t:.4f}' for t in turns[want_ed])}; "
                             f"simt {', '.join(f'{t:.4f}' for t in turns['simt'])}]")
            else:
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
            print(f"  {c['name']:18s} {tag:8s} max_abs_err {err:.3e} max_rel_err "
                  f"{err / max(scale, 1e-30):.3e} {'ok' if ok else 'FAIL'} | "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                  f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound {bound_ms:.4f} ms "
                  f"({bound_by}: {c['bytes'](it) / 1e6:.1f} MB, {c['ops'] / 1e9:.2f} GFLOP)"
                  + simt_text + repeat_text)
            if not ok:
                failures.append(f"{c['name']} {tag}: max abs err {err:.3e} (max|plain| {scale:.3e})")
            records[(c["name"], tag)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)
            del inputs
            torch.cuda.empty_cache()
    failures += backward_repeat(smi, randn, t_homs)
    if failures:
        print("kernel phase FAILED:\n  " + "\n  ".join(failures))
        return 1

    # ---- 4. inference: 3 requests at the operating point
    cfg = ModelConfig(view_num=3, max_d=192, width=1152, height=864,
                      network_mode="normal", compute_dtype="bfloat16")
    predictor = Predictor(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_request, editions = [], [], []
    for _ in range(3):
        before, ed_before = kernels.launch_counts(), kernels.edition_counts()
        t0 = time.perf_counter()
        depth, prob, _ = predictor.predict(*request, fetch=False)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after, ed_after = kernels.launch_counts(), kernels.edition_counts()
        per_request.append({k: after[k] - before[k] for k in after})
        editions.append({k: {e: n - ed_before[k][e] for e, n in v.items()}
                         for k, v in ed_after.items()})
        if not (torch.isfinite(depth).all() and torch.isfinite(prob).all()):
            print("inference FAILED: non-finite depth or prob")
            return 1
    peak = torch.cuda.max_memory_allocated()
    print(f"inference: 3 requests at 1152x864, D=192, V=3, normal, bf16: wall ms "
          f"{', '.join(f'{w:.2f}' for w in walls)}; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"depth {tuple(depth.shape)} in [{depth.min().item():.1f}, {depth.max().item():.1f}], "
          f"prob in [{prob.min().item():.3f}, {prob.max().item():.3f}]")
    print(f"  launches per request: {per_request}")
    print(f"  launches per request and edition: {editions}")
    if any(r != EXPECTED_LAUNCHES for r in per_request):
        print(f"inference FAILED: launches per request {per_request} != {EXPECTED_LAUNCHES}")
        return 1
    if any(r != EXPECTED_EDITIONS for r in editions):
        print(f"inference FAILED: editions per request {editions} != {EXPECTED_EDITIONS}")
        return 1

    # one more request, stage by stage (after the counts were read)
    model = predictor.model
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
    if not layer_times(smi, predictor, request):
        print("inference FAILED: a layer ran the wrong edition")
        return 1
    print_profile("request", *profile_device(
        lambda: predictor.predict(*request, fetch=False)))
    del predictor, model, depth, prob, ref_f, view_f, cost, reg
    torch.cuda.empty_cache()

    # ---- 5. inference end to end: card kernels vs CPU plain path, float32
    small = ModelConfig(view_num=3, max_d=32, width=320, height=256,
                        network_mode="normal", compute_dtype="float32")
    s_images, s_cams = scene(1, 3, 256, 320, 32, seed=1)
    s_ds, s_di, _, s_de = depth_params_from_cams(s_cams)
    d_gpu, p_gpu, _ = Predictor(small, seed=1, device=dev).predict(
        s_images, s_cams, s_ds, s_di, s_de)
    d_cpu, p_cpu, _ = Predictor(small, seed=1, device="cpu").predict(
        s_images, s_cams, s_ds, s_di, s_de)
    d_err = float(np.abs(d_gpu - d_cpu).max())
    p_err = float(np.abs(p_gpu - p_cpu).max())
    ok = (np.isfinite(d_gpu).all() and np.isfinite(p_gpu).all()
          and d_err <= E2E_DEPTH_ATOL and p_err <= E2E_PROB_ATOL)
    print(f"inference end to end 320x256 D=32 normal f32, card vs CPU: depth max abs err "
          f"{d_err:.3e} (bound {E2E_DEPTH_ATOL:g}), prob max abs err {p_err:.3e} "
          f"(bound {E2E_PROB_ATOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        return 1

    # ---- 6. training: 3 steps at the reference training point
    t_cfg = ModelConfig(view_num=3, max_d=192, width=640, height=480,
                        network_mode="normal", compute_dtype="bfloat16")
    tcfg = TrainConfig()
    t_model = MVSNet(t_cfg, seed=0)
    state = train_lib.create_train_state(t_model, t_cfg, tcfg, device=dev)
    train_step = train_lib.make_train_step(t_model, t_cfg, tcfg)
    expected = expected_train_launches(t_model, t_cfg, 120, 160)
    expected_wgrad = expected_wgrad_editions(t_model, torch.bfloat16)
    params = list(t_model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_step, step_losses, step_wgrad = [], [], [], []
    for _ in range(3):
        before, ed_before = kernels.launch_counts(), kernels.edition_counts()["wgrad"]
        t0 = time.perf_counter()
        state, metrics = train_step(state, t_batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after, ed_after = kernels.launch_counts(), kernels.edition_counts()["wgrad"]
        per_step.append({k: after[k] - before[k] for k in after})
        step_wgrad.append({e: n - ed_before[e] for e, n in ed_after.items()})
        finite = torch.stack([torch.isfinite(p.grad).all() for p in params]).all()
        step_losses.append(metrics["loss"].item())
        if not (np.isfinite(step_losses[-1]) and bool(finite)):
            print(f"training FAILED: loss {step_losses[-1]}, all gradients finite: {bool(finite)}")
            return 1
    train_launches = kernels.launch_counts()
    train_editions = kernels.edition_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"training: 3 steps at 640x480, D=192, V=3, normal, bf16, rmsprop, power+grad "
          f"loss: step ms {', '.join(f'{w:.2f}' for w in walls)} (the first includes "
          f"set-up); peak memory {peak / 2 ** 30:.3f} GiB; losses "
          f"{', '.join(f'{v:.4f}' for v in step_losses)}")
    print(f"  launches per step: {per_step}; editions over the 3 steps: {train_editions}; "
          f"wgrad editions per step {step_wgrad} (expected {expected_wgrad})")
    if any(r != expected for r in per_step):
        print(f"training FAILED: launches per step {per_step} != {expected}")
        return 1
    if any(r != expected_wgrad for r in step_wgrad):
        print(f"training FAILED: wgrad editions per step {step_wgrad} != {expected_wgrad}")
        return 1

    # one more step, stage by stage (after the counts were read)
    batch = train_lib.to_device(t_batch, dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    state.optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    loss, _ = train_lib.compute_loss(t_model, t_cfg, tcfg, batch, training=True)
    ev[1].record()
    loss.backward()
    ev[2].record()
    train_lib.apply_gradients(state, tcfg)
    ev[3].record()
    torch.cuda.synchronize()
    names = ["forward", "backward", "optimizer"]
    print("  stages (ms, CUDA events, one step): "
          + ", ".join(f"{n} {ev[i].elapsed_time(ev[i + 1]):.3f}" for i, n in enumerate(names)))
    print_profile("step", *profile_device(lambda: train_step(state, t_batch)))
    del state, t_model, train_step, params, batch, loss
    torch.cuda.empty_cache()

    # ---- 7. one train step: card kernels vs CPU plain path, float32
    s_cfg = ModelConfig(view_num=3, max_d=16, width=128, height=128,
                        network_mode="normal", compute_dtype="float32")
    s_batch = train_scene(128, 128, 16, seed=3)
    runs = []
    for device in (dev, dev, "cpu"):
        m = MVSNet(s_cfg, seed=3)
        perturb_norms(m, seed=4)
        st = train_lib.create_train_state(m, s_cfg, tcfg, device=device)
        _, met = train_lib.make_train_step(m, s_cfg, tcfg)(st, s_batch)
        runs.append((met["loss"].item(),
                     {n: p.grad.cpu().numpy() for n, p in m.named_parameters()},
                     {n: b.cpu().numpy() for n, b in m.named_buffers()}))
    ok, text = step_errors(runs[0], runs[2])
    print(f"train step 128x128 D=16 normal f32, card vs CPU: {text}")
    repeat, first = repeat_difference(runs[0], runs[1])
    print(f"  two card steps from the same state and batch: largest difference {repeat:.3e}"
          + ("" if first is None else f", first in {first}") + f" (bound 0) "
          f"{'ok' if repeat == 0 else 'FAIL'}")
    if not ok or repeat != 0:
        return 1

    # ---- 8. multi-GPU serving and training
    k1s = phase8(smi, dev, randn, homs, request)
    if k1s is None:
        return 1

    # ---- records: launches from the training run of phase 6; K1s's from
    # the latency requests of phase 8 (all ranks)
    out = []
    for c in cases:
        r = records[(c["name"], str(c.get("path_dtype", torch.bfloat16)).replace("torch.", ""))]
        out.append(dict(name=c["name"], route="cuda", source=c["source"],
                        replaces=c["replaces"], launches=train_launches[c["counter"]], **r))
    return report(out + [k1s])


def phase8(smi, dev, randn, homs, request):
    """Phase 8; returns K1s's kernel record, or None on failure."""
    backend, n, serve_mesh = serving_setup()
    k1s = phase8_sharded_cost(smi, randn, homs, serve_mesh)
    if k1s is None:
        return None
    launches = phase8_ranks(smi, dev, request, backend, n)
    if launches is None:
        return None
    return dict(name="cost_volume_sharded", route="cuda",
                source="mvsnet_tpu_torch/csrc/cost_volume.cu",
                replaces="mvsnet_tpu/ops/pallas/sweep.py:2032", launches=launches, **k1s)


def report(kernel_records) -> int:
    """The last lines: the kernels' record, the card, the result."""
    print(json.dumps({"kernels": kernel_records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
