"""Drive the PyTorch/CUDA port (`mvsnet_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --multi    # phases 1, 2, 8 and 8i only (four cards)

Phases run in the order 1-7, 10-13, 8, 9, 14, 15, 16.

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
     timed in both editions, in turns (tc, simt, simt, tc), and each
     edition's device time (CUDA events over a CUDA graph of 20 calls, no
     host time between launches) beside cuDNN's, taken the same way; the
     rows whose Cin is not a multiple of 8 (the image convs' 3, the
     refinement's 5, the GRU cells' 1, 2, 6, 10, 20) run the tensor cores
     with Cin zero-padded in shared memory; the transposed
     warp is called twice on the same inputs, which must agree bit for bit,
     and so must two calls of the cost volume's backward at the training
     point (bf16); the GRU serving path's rows: the seven convs of the
     ConvGRU cells and prob_conv at R-MVSNet's serving point (features
     296x400, Cin 48, 20, 6, 2), K1 over its 256 planes, and two tower
     convs at 1184x1600; the GRU training path's rows at the bench
     `train_gru` point ("lite", features 120x160x16, D=192): K1, K2 and K3
     at C = 16, and each cell conv (Cin 24, 10, 3, 1) forward, its input
     gradient and its weight gradient; the refinement U-Net's rows at the
     refined-serving point (1x864x1152: `2dconv0_1_refine` 5->8 and
     `2dconv1_0_refine` 5->16 s2, `2dconv8_3_refine`
     8->32, `2dconv8_4_refine` 32->1, `2dconv5_1_refine` 128->64 at
     108x144, the transposed conv `2dconv5_0_refine` 128->64 from 54x72) and
     at the training point (640x480: the Cin = 5 conv's weight gradient and
     input gradient); K2 and K3 with a row offset at 8g's block (a slab of
     96 planes, rows whole), and on two row blocks of 60: K2's blocks
     stitched equal one launch bit for bit, K3's blocks summed equal one
     launch within float32's tolerance, each block its plain version;
  4. inference: `Predictor` at 1152x864, D=192, 3 views, "normal",
     bfloat16, seeded weights, answers 3 requests; launch counts per
     request are asserted (cost volume 1, conv 36, deconv 7; every one on
     the tensor cores), then one more
     request is timed stage by stage and one is profiled;
  5. inference end to end at 320x256, D=32, "normal", float32: the card's
     kernel path against the CPU's plain path with the same weights and
     inputs;
  6. training: `make_train_step` at 640x480, D=192, 3 views, "normal",
     bfloat16 with float32 parameters, RMSprop, power + gradient loss,
     seeded weights and a synthetic scene, takes 3 steps; launch counts per
     step, and the weight gradient's editions (tc 43), are asserted
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
        D=16, B=2 against the single-card step (phase 7's bounds);
     d. on the same ranks, R-MVSNet throughput serving at 320x256, D=32,
        "normal", bf16, B = ranks and B = ranks - 1 (padded to the ranks):
        equal bit for bit to the single-card GRU `Predictor`, one call per
        map; and `entry.gru_dryrun`, the dry run's GRU regime;
     e. on the same ranks, refined serving (the U-Net upsampled with
        confidence) at 320x256, D=32, "normal", float32: the latency
        regime (B=1; every rank refines the gathered maps whole) within
        phase 5's bounds and the residual within 1e-3 of max(1,
        max|residual|), the throughput regime (B = ranks) equal bit for
        bit, against the single-card refined `Predictor`, one call per map;
     f-h. the volume in depth x space blocks: 4 ranks (one NCCL rank a
        card with four cards, else four gloo-cuda ranks on the one card),
        then 2 the same way:
     f. latency serving on (1,2,2) at phase 4's point, 3 requests: depth
        and prob against phase 4's single-card `Predictor` within 8b's
        bounds, K1s once a request and rank, conv 36 and deconv 7 a
        request and rank (the feature tower's and the U-Net's halo convs),
        each rank's stages (host clock and CUDA events), halo exchanges
        (the tower's apart from the U-Net's), the tower's norm sums and
        peak memory beside phase 4's, and every tensor of one request
        recorded: none a whole (D, h, w) volume; the tower alone on each
        rank's rows (`tower_profile`): its ms by CUDA events, its 30
        exchanges and 31 norm sums (bf16) each timed alone, its largest tensor,
        no whole (B·V, H/2^l, W/2^l, C) map and no whole-tower warning;
     g. one f32 blocked train step at 128x128, D=16, B=2 on (1,2,2) and on
        (1,2,1) against 8c's single-card step (phase 7's bounds); 3 bf16
        steps at phase 6's point on (1,2,1) and on (1,2,2), timed,
        launches per step asserted (K1s 1, K2 and K3 with a row offset 2
        each, the convs as phase 6's), each rank's peak beside phase 6's;
        on (1,2,2) the tower alone in training, forward and backward, as
        in 8f, with the backward's 30 all_gathers and 31 all_reduces;
     h. one R-MVSNet "ultralite" f32 train step at 128x128, D=16 with the
        sweep's rows on (1,1,2) against the single-card step; R-MVSNet's
        tower ("lite") alone in training on (1,1,2) at phase 6's size;
     i. with `--multi` on four cards only: `python -m mvsnet_tpu_torch.
        train --num_devices 4` (3 steps, 640x480, D=192, lite, float32,
        batch 2 over (2,2,1)) and `infer` / `test --num_devices 4` (phase
        14's point, float32, refinement, one cluster) under
        `torch.distributed.run`, each against the same command on one card:
        exit codes 0, the first step's loss within phase 7's 1e-4, the
        maps within phase 5's bounds, the results CSV within 1e-2;
  9. the training driver (`python -m mvsnet_tpu_torch.train`'s `main`):
     a. at the bench train point (640x480, D=192, 3 views, "lite", bf16,
        RMSprop, power + gradient loss), 6 steps with a validation round,
        as a user runs it, on plane scenes rendered by `data/synthetic.py`
        and written to disk as sessions (JPEGs by the port's encoder), read
        by `train.make_loader`'s `ClusterGenerator` with the port's
        decoders; the host time a sample takes to decode and transform.
        Launches per step and the conv, transposed-conv and weight-gradient
        editions are asserted against counts derived from the model, and
        every kernel of the path must have launched;
     b. resuming: 4 steps, a snapshot, `--ckpt_step 4` and 2 more steps
        must end equal, bit for bit, to the 6 straight steps (parameters,
        batch-norm statistics, RMSprop state); the restored state equals
        the saved one bit for bit, and `latest_step` reads 6;
     c. the port's convergence gate (`tests/test_convergence.py:55-65`):
        600 adam steps, "ultralite", 64x64, D=16, float32, on the
        three-depth plane scenes rendered in memory; the mean loss of the
        last 12 steps under 0.1 of the first 12's, their mean <3px
        accuracy over 0.9;
     d. the port's bench script (`mvsnet_tpu_torch/bench.py`): its
        `depth_maps_per_sec_1152x864_d192_3dcnn`,
        `train_step_sec_640x480_d192_lite`,
        `depth_maps_per_sec_1600x1184_d256_gru_wta` and
        `train_step_sec_640x480_d192_gru_lite` lines; one convergence step
        and one bench train step are profiled;
 10. R-MVSNet serving: the GRU `Predictor` at 1600x1184, D=256, 3 views,
     "normal", bf16, seeded weights (the bench `gru` point's shapes): a first
     request (it captures the depth step as a CUDA graph), then 3 timed
     requests with launches per request and edition asserted against counts
     derived from the model (K1 once, the tower's convs once, the cells'
     convs once a plane), peak memory, one request stage by stage and one
     profiled, whose kernel launches the profiler sees (most of them CUDA
     graph replays) must equal the wrappers' counts by kernel and edition;
     the graph-replayed sweep against the eager sweep on the same
     cost volume, regs, depth and prob bit for bit; the card against the
     CPU at 320x256, D=32, "normal", float32 (regs within 1e-3 of max(1,
     max|regs|), depth equal wherever a pixel's top two regs differ by more
     than that, prob within phase 5's 1e-3);
 11. R-MVSNet training (classification loss): 3 `make_train_step` steps at
     the bench `train_gru` point (640x480, D=192, "lite", bf16,
     `TrainConfig()`), launches and editions per step asserted, stages by
     CUDA events, one step profiled; two "normal" steps at the same point,
     timed, with their peak; one float32 step at 128x128, D=16, "normal",
     card against CPU within phase 7's bounds, and two card steps bit for
     bit;
 12. refined serving: `Predictor` at phase 4's point with refinement as
     the training driver sets it (the U-Net, upsampled to the images, with
     the confidence channel), seeded weights: a first request, then 3
     requests with launches per request and edition asserted against the
     counts derived from the model (conv 60 and deconv 11, all tc),
     peak memory, one request stage by stage (features, cost volume,
     U-Net, tail, upsample, refinement net; equal bit for bit to the
     Predictor's) and one profiled; one request each of the original net
     with the stereo view (its first conv on the tensor cores) and of the
     U-Net at the cost volume's resolution (1024x768); the card against the
     CPU at 320x256, D=32, float32 (refined depth within phase 5's 0.05,
     prob 1e-3, residual within 1e-3 of max(1, max|residual|));
 13. refined training ("all" mode): 3 `make_train_step` steps at the
     training point (640x480, D=192, "normal", bf16, power + gradient
     loss against the full-resolution depth), launches and editions per
     step asserted, stages by CUDA events, one step profiled; one float32
     step at 128x128, D=16, card against CPU within phase 7's bounds, and
     two card steps bit for bit;
 14. the serving drivers with refinement: `infer.main` (upsampled) and
     `test.main` (at the cost volume's resolution, its depth resized to the
     ground truth) at the test driver's point (512x384, V=4, D=192,
     "normal", bf16, the U-Net with confidence) on sessions rendered by
     `data/synthetic.py` and written to disk (the images as JPEGs by the
     port's encoder), the weights restored from a checkpoint this phase
     saved through `--model_dir --ckpt_step`; the drivers read the JPEGs
     with the port's decoder and write each reference image `<index>.jpg`
     with its encoder; every PFM, PNG, reference JPEG (the port's decoders)
     and cam file read back, the results CSV's row checked, the writer
     thread's time and its JPEG writes', and K1, the conv and the
     transposed conv launched;
 15. TF-checkpoint import, the user's chain to a point cloud, and fusion
     (`tf_import`, `fusion`, `native/`, `visualize`, `utils/profiling`):
     a. Saver V2 bundles in the reference's TF names and layouts, written
        by `io/tf_bundle.write_bundle` from seeded models (3D-CNN "normal"
        with the refinement U-Net as the test driver sets it; the GRU
        "normal"), imported by `import_checkpoint`: the restored state dict
        equals the seeded one bit for bit, and `Predictor(mcfg, model_dir,
        ckpt_step)` answers bit-equal to a `Predictor` of the seeded state
        dict (1152x864, D=192 and 320x256, D=32, bf16); bundle read,
        mapping and restore times;
     b. `infer.main --model_dir <imported> --ckpt_step` with refinement at
        phase 14's point, then `fusion.main --dense_folder` on the card:
        the reference's thresholds, 2 shards merged (the same points as
        unsharded), the native consolidation, `--mode gipuma-export`
        (.P and .dmb files read back); the session's JPEGs and the
        reference images `<index>.jpg` fusion colours its points from go
        through the port's codec; K1, the conv and the transposed conv
        launched;
     c. `fusion.fuse_reference` over the 49 views (a 7x7 grid of cameras,
        a DTU evaluation scan's count) of tests/test_fusion_quality.py's
        analytic sphere-cap scene at 1152x864 with the reference's
        thresholds: that test's accuracy and completeness gates, wall
        time, time a view and a pair beside the pair's bound, peak memory,
        one reference view profiled; the native voxel merge of the whole
        cloud timed; 8 views at 320x256 on the card against the CPU (keep
        masks within 1e-3 of the pixels, matched points within 1e-4 of the
        scene's depth); the native library against its numpy plain
        versions on that cloud, after sorting;
     d. `visualize.load_depth_any` on 15b's .pfm, .png and .dmb files,
        `utils.profiling.trace` around one `Predictor` call, and
        `device_memory_stats()`;
 16. from a DTU-layout scan to a scored cloud, with no image codec
     installed (`tools/`, `scripts/`, `io/jpeg.py`, `native/jpeg.cpp`):
     a. `data.synthetic.write_dtu_scan` writes one scan in DTU's training
        layout (49 views, 7 lightings, 640x512 RGB PNGs, 160x128 depth
        PFMs, cams and pair.txt); `tools.convert_dtu`, `tools.dtu_fixer`
        and `tools.split_data` turn it into sessions as a user runs them,
        timed; every file of the test session reads back (the JPEGs by the
        port's decoder);
     b. `scripts.test_and_fuse --device cuda:0 --prob_threshold 0
        --num_consistent 1` over the test split's session (640x512, V=3,
        D=192, "normal", bf16, seeded weights, whose prob stays under the
        0.8 default): a non-empty PLY collected into `--ply_folder`, the
        results CSV's rows, and K1, the conv and the transposed conv
        launched;
     c. `tools.eval_pointcloud` on phase 15c's fused cloud (a PLY) against
        2M points spread over the analytic sphere cap: its accuracy median
        and p90 and its completeness (recall at 20 mm) within 15c's gates;
        on 16b's PLY against the rendered plane: its JSON line;
     d. the native codec against its plain version (`io/jpeg.py`,
        `io/images._unfilter`): a small image in each sampling, encoded to
        the same bytes and decoded to the same samples; PNG rows filtered
        with each of the five filter types by a numpy forward filter; and
        the native codec's ms per image at 640x512, 1152x864 and 1600x1200
        on the host CPU.
The last lines are the kernels' JSON record (launches from the training
run of phase 6, the GRU rows' from the requests of phase 10 and the
training steps of phase 11, the refinement rows' from the requests of
phase 12 and the steps of phase 13; K1s's from the latency requests of
8b, the row-offset K2 and K3's from 8g's bf16 steps, summed over ranks),
the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import dataclasses
import os
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
                     "warp": 0, "warp_transpose": 0, "warp_sharded": 0,
                     "warp_transpose_sharded": 0, "wgrad": 0}
# per bf16 request: every conv and deconv on the tensor cores, the two convs
# on the 3-channel images (2dconv1_0, 2dconv0_1) with Cin zero-padded
EXPECTED_EDITIONS = {"conv": {"tc": 36, "simt": 0}, "deconv": {"tc": 7, "simt": 0},
                     "wgrad": {"tc": 0, "simt": 0}}
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
# R-MVSNet, card vs CPU, float32: the regs after the tower, the cost volume
# and 32 depth steps, within this share of max(1, max|regs|); the
# winner-take-all depth is compared where a pixel's top two regs are
# further apart than that (closer ones may take either plane)
GRU_REGS_TOL = 1e-3
# a gradient that vanishes analytically (prob_conv's bias, a constant over
# the planes that the softmax removes) is rounding noise on both sides: held
# below this share of the largest gradient entry instead of to TRAIN_GRAD_TOL
VANISHING_TOL = 1e-6


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


def graph_ms(fn, calls=20, replays=5):
    """Device ms of one call of fn: `calls` calls captured in one CUDA graph
    (`kernels.CountedGraph`, after its warm-up), replayed `replays` times
    between two CUDA events. The launches follow one another on the card
    with no host time between them, as in a captured step; the replays are
    a measurement and count no launches."""
    from mvsnet_tpu_torch.ops.kernels import CountedGraph

    graph = CountedGraph(lambda: [fn() for _ in range(calls)], torch.device("cuda", 0)).graph
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


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


def module_calls(model):
    """Calls of a module in one forward (B = 1): the GRU sweep's modules run
    once a plane, every other module once."""
    gru = set(model.gru_sweep.modules()) if hasattr(model, "gru_sweep") else set()
    return lambda m: model.cfg.max_d if m in gru else 1


def expected_train_launches(model, cfg, h, w):
    """Kernel launches of one train step (B = 1), derived from the model:
    every conv and transposed conv runs forward once (a GRU cell's once a
    plane, `module_calls`) and has one weight gradient a run; every conv but
    the two on the images (2dconv1_0 and 2dconv0_1 take the images, which
    need no gradient) has an input gradient, on the conv kernel at stride 1
    and on the transposed-conv kernel at stride 2; every transposed conv's
    input gradient is a stride-2 conv; the cost volume runs K1 forward, and
    K2 and K3 once per source view and depth chunk backward."""
    from mvsnet_tpu_torch.models.layers import Conv, Deconv
    from mvsnet_tpu_torch.ops.cost_volume import ACC_LIMIT_BYTES

    fn = model.feature_net._modules
    image_convs = {fn["2dconv1_0"].conv, fn["2dconv0_1"].conv}
    calls = module_calls(model)
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    deconvs = [m for m in model.modules() if isinstance(m, Deconv)]
    n_conv, n_deconv = sum(map(calls, convs)), sum(map(calls, deconvs))
    dx_s1 = sum(calls(c) for c in convs if c.stride == 1 and c not in image_convs)
    dx_s2 = sum(calls(c) for c in convs if c.stride == 2 and c not in image_convs)
    V, C = cfg.view_num, cfg.feature_channels
    chunks = max(1, -(-(V * cfg.max_d * h * w * C * 4) // ACC_LIMIT_BYTES))
    return {"cost_volume": 1, "cost_volume_sharded": 0,
            "conv": n_conv + dx_s1 + n_deconv,
            "deconv": n_deconv + dx_s2, "warp": (V - 1) * chunks,
            "warp_transpose": (V - 1) * chunks, "warp_sharded": 0,
            "warp_transpose_sharded": 0, "wgrad": n_conv + n_deconv}


def expected_wgrad_editions(model, dtype):
    """Weight-gradient launches of one train step by edition: a conv's dk
    is wgrad(x, g) on (Cin, Cout), a transposed conv's wgrad(g, x) on (Cout,
    Cin), once a run (`module_calls`); each runs the edition
    `wgrad.pick_edition` gives its channels (bf16: "tc" at every Cin)."""
    from mvsnet_tpu_torch.models.layers import Conv, Deconv
    from mvsnet_tpu_torch.ops.kernels import wgrad

    calls = module_calls(model)
    counts = {e: 0 for e in wgrad.EDITIONS}
    for m in model.modules():
        if isinstance(m, (Conv, Deconv)):
            cin, cout = m.kernel.shape[-2:]
            if isinstance(m, Deconv):
                cin, cout = cout, cin
            counts[wgrad.pick_edition(dtype, cin, cout)] += calls(m)
    return counts


def expected_train_editions(model, dtype):
    """Launches of one train step by kernel and edition, derived from the
    model as `expected_train_launches` counts them: each conv's forward on
    (Cin, Cout); a stride-1 conv's input gradient on the conv kernel and a
    stride-2 conv's on the transposed-conv kernel, both on (Cout, Cin);
    each transposed conv's forward on (Cin, Cout) and its input gradient,
    a stride-2 conv, on (Cout, Cin); the weight gradients by
    `expected_wgrad_editions`."""
    from mvsnet_tpu_torch.models.layers import Conv, Deconv
    from mvsnet_tpu_torch.ops.kernels import conv

    fn = model.feature_net._modules
    image_convs = {fn["2dconv1_0"].conv, fn["2dconv0_1"].conv}
    calls = module_calls(model)
    counts = {k: {e: 0 for e in conv.EDITIONS} for k in ("conv", "deconv")}

    def add(kind, cin, cout, n):
        counts[kind][conv.pick_edition(dtype, cin, cout)] += n

    for m in model.modules():
        if isinstance(m, (Conv, Deconv)):
            cin, cout = m.kernel.shape[-2:]
            if isinstance(m, Conv):
                add("conv", cin, cout, calls(m))
                if m not in image_convs:
                    add("conv" if m.stride == 1 else "deconv", cout, cin, calls(m))
            else:
                add("deconv", cin, cout, calls(m))
                add("conv", cout, cin, calls(m))
    counts["wgrad"] = expected_wgrad_editions(model, dtype)
    return counts


def expected_serving(model, dtype):
    """Launches of one eval request (B = 1) by kernel, and by edition, derived
    from the model: K1 once; every conv and transposed conv once a run
    (`module_calls`: a GRU cell's once a plane), in the edition
    `conv.pick_edition` gives its channels."""
    from mvsnet_tpu_torch.models.layers import Conv, Deconv
    from mvsnet_tpu_torch.ops.kernels import conv

    calls = module_calls(model)
    editions = {k: {e: 0 for e in conv.EDITIONS} for k in ("conv", "deconv", "wgrad")}
    for m in model.modules():
        if isinstance(m, (Conv, Deconv)):
            cin, cout = m.kernel.shape[-2:]
            kind = "conv" if isinstance(m, Conv) else "deconv"
            editions[kind][conv.pick_edition(dtype, cin, cout)] += calls(m)
    launches = {"cost_volume": 1, "cost_volume_sharded": 0, "warp": 0, "warp_transpose": 0,
                "warp_sharded": 0, "warp_transpose_sharded": 0,
                "wgrad": 0, "conv": sum(editions["conv"].values()),
                "deconv": sum(editions["deconv"].values())}
    return launches, editions


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
            elif name.endswith((".gn.bias", ".bn.bias", "norm.bias", "mean")):
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
    source and edition. Returns whether every layer ran the tensor-core
    edition, as the rule gives bf16 at every Cin."""
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
        want = "tc"
        ok = ok and ed == want
        print(f"    {name:32s} {kind:6s} in {xs} k {ws} {ed:4s} {ms:8.4f} ms  bound "
              f"{bound:.4f} ms{'' if ed == want else '  WRONG EDITION'}")
    print("  per source and edition (launches, ms, bound ms): " + "; ".join(
        f"{k} {n}, {t:.4f}, {b:.4f}" for k, (n, t, b) in sorted(sums.items())))
    return ok and len(calls) == 43


def profile_device(fn):
    """Wall ms, device-busy ms, the device events and the host events of one
    call of fn under torch.profiler; busy is None when the profiler saw no
    device time."""
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
    host_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    return wall_ms, (busy_ms if busy_ms > 0 else None), dev_events, host_events


# the port's kernels by source and pass, as the profiler names them
KERNEL_FAMILIES = (("wgrad tc", "wgrad_tc_kernel"), ("wgrad simt", "wgrad_partial_kernel"),
                   ("wgrad reduce", "wgrad_reduce_kernel"), ("cost_volume", "cost_volume_kernel"),
                   ("conv/deconv tc", "tc_conv_kernel"), ("conv simt", "::conv_kernel"),
                   ("warp", "::warp_kernel"), ("warp transpose", "warp_transpose_kernel"),
                   ("warp transpose plan", "::plan_kernel"),
                   ("warp transpose run sum", "segment_sum_kernel"))


def profiled_launches(events):
    """Launches the profiler saw by kernel and edition, in the form of the
    wrappers' counts (`kernels.launch_counts`, `kernels.edition_counts`),
    for the kernels of a serving request: K1, and the conv and transposed
    conv in both editions (the tensor-core kernel serves both)."""
    def seen(pattern):
        return sum(e.count for e in events if pattern in e.key)
    return {"cost_volume": seen("cost_volume_kernel"),
            "conv/deconv tc": seen("tc_conv_kernel"),
            "conv simt": seen("::conv_kernel"), "deconv simt": seen("::deconv_kernel")}


def counted_launches(before, after):
    """The wrappers' counts between two (launch_counts, edition_counts)
    readings, in `profiled_launches`' form."""
    (l0, e0), (l1, e1) = before, after
    ed = {k: {e: n - e0[k][e] for e, n in v.items()} for k, v in e1.items()}
    return {"cost_volume": l1["cost_volume"] - l0["cost_volume"] + l1["cost_volume_sharded"]
            - l0["cost_volume_sharded"],
            "conv/deconv tc": ed["conv"]["tc"] + ed["deconv"]["tc"],
            "conv simt": ed["conv"]["simt"], "deconv simt": ed["deconv"]["simt"]}


def print_profile(what, wall_ms, busy_ms, events, host_events):
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
    host = sorted(host_events, key=lambda e: -e.self_cpu_time_total)[:8]
    print("    top host self time: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}" for e in host))


def step_errors(got, ref, vanishing=()):
    """(loss rel err, global gradient err, worst leaf, its err, running
    statistics err) of one train step's (loss, grads, buffers) against
    another's, as phase 7 bounds them. The leaves named in `vanishing`
    have gradients that vanish analytically: each must stay under
    VANISHING_TOL of the largest gradient entry on both sides."""
    (l_got, g_got, b_got), (l_ref, g_ref, b_ref) = got, ref
    loss_err = abs(l_got - l_ref) / abs(l_ref)
    top = max(float(np.abs(g).max()) for g in g_ref.values())
    tiny = all(max(float(np.abs(g_got[n]).max()), float(np.abs(g_ref[n]).max()))
               <= VANISHING_TOL * top for n in vanishing)
    leaf_err = {n: float(np.abs(g_got[n] - g).max()) / max(float(np.abs(g).max()), 1e-12)
                for n, g in g_ref.items() if n not in vanishing}
    worst = max(leaf_err, key=leaf_err.get)
    global_err = float(np.sqrt(sum(float(((g_got[n] - g) ** 2).sum()) for n, g in g_ref.items())
                               / sum(float((g ** 2).sum()) for g in g_ref.values())))
    stats_err = max((float(np.abs(b_got[n] - b).max()) / max(1.0, float(np.abs(b).max()))
                     for n, b in b_ref.items()), default=0.0)
    ok = (np.isfinite(l_got) and loss_err <= TRAIN_LOSS_RTOL and tiny
          and global_err <= TRAIN_GRAD_GLOBAL_TOL and leaf_err[worst] <= TRAIN_GRAD_TOL
          and stats_err <= TRAIN_STATS_TOL)
    text = (f"loss rel err {loss_err:.3e} (bound {TRAIN_LOSS_RTOL:g}), gradients "
            f"{global_err:.3e} in the global norm (bound {TRAIN_GRAD_GLOBAL_TOL:g}), worst "
            f"leaf {worst} {leaf_err[worst]:.3e} of its max (bound {TRAIN_GRAD_TOL:g}), "
            f"running stats {stats_err:.3e} (bound {TRAIN_STATS_TOL:g})"
            + (f", vanishing leaves {list(vanishing)} under {VANISHING_TOL:g} of the largest "
               f"gradient: {tiny}" if vanishing else "") + f" {'ok' if ok else 'FAIL'}")
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


def warp_row_blocks(smi, randn, hm, H=120, W=160, C=32, rows=60):
    """K2 and K3 with a row offset on the row blocks of 8g's (1,2,2) mesh
    at the training point (a depth slab of 96 planes, rows [0, 60) and [60,
    120)): K2's blocks stitched equal one whole launch bit for bit, K3's
    blocks' gradients of the source map add up to one whole launch's, and
    each block agrees with its plain version (tolerances as phase 3).
    Returns failures."""
    from mvsnet_tpu_torch.ops.kernels import warp

    failures = []
    D = hm.shape[0]
    for dtype in (torch.float32, torch.bfloat16):
        img, g = randn((H, W, C), dtype), randn((D, H, W, C), dtype)
        whole = warp.warp_all_depths(img, hm)
        blocks = [warp.warp_all_depths(img, hm, r, rows) for r in range(0, H, rows)]
        stitched = torch.equal(torch.cat(blocks, dim=1), whole)
        t_whole = warp.warp_transpose(g, hm)
        t_sum = sum(warp.warp_transpose(g[:, r:r + rows], hm, r, H) for r in range(0, H, rows))
        t_err = (t_sum - t_whole).abs().max().item()
        t_ok = t_err <= TOL[torch.float32] * max(1.0, t_whole.abs().max().item())
        errs = []
        for r in range(0, H, rows):
            got = warp.warp_all_depths(img, hm, r, rows).float()
            want = warp.warp_all_depths_plain(img, hm, r, rows).float()
            errs.append(((got - want).abs().max().item(), TOL[dtype] * max(1.0, want.abs().max().item())))
            got = warp.warp_transpose(g[:, r:r + rows], hm, r, H)
            want = warp.warp_transpose_plain(g[:, r:r + rows], hm, r, H)
            errs.append(((got - want).abs().max().item(),
                         TOL[torch.float32] * max(1.0, want.abs().max().item())))
        plain_ok = all(e <= t for e, t in errs)
        tag = str(dtype).replace("torch.", "")
        print(f"  K2/K3 row blocks {tag}: {H // rows} blocks of {rows} rows x {D} planes: K2 "
              f"stitched == one launch {stitched}; K3 blocks summed vs one launch max abs err "
              f"{t_err:.3e} {'ok' if t_ok else 'FAIL'}; blocks vs plain max abs err "
              f"{max(e for e, _ in errs):.3e} {'ok' if plain_ok else 'FAIL'} [{smi}]")
        if not (stitched and t_ok and plain_ok):
            failures.append(f"K2/K3 row blocks {tag}")
        del img, g, whole, blocks, t_whole, t_sum
    torch.cuda.empty_cache()
    return failures


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


# phase 8d: R-MVSNet throughput serving on the ranks
GRU_MULTI_CFG_ARGS = dict(view_num=3, max_d=32, width=320, height=256, network_mode="normal",
                          regularization="GRU", compute_dtype="bfloat16")


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


def phase8_ranks(smi, dev, serve_in, backend, n, two=None):
    """8b and 8c: serving in both regimes and one sharded train step on
    several ranks (`phase8_rank`), against the single-card `Predictor` and
    train step on the same inputs. Returns the K1s launches of the latency
    requests summed over ranks, the references (phase 4's latency answer,
    8c's single-card step) and, when the world has two ranks and `two`
    (8g's bf16 batch and point) is given, each rank's `blocks_two`
    results; or None on failure."""
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
    # 8d's reference: the single-card GRU Predictor, one call per map
    g_pred = Predictor(ModelConfig(**GRU_MULTI_CFG_ARGS), seed=0, device=dev)
    gru_in, gru_ref = {}, {}
    for B in (n, n - 1):
        g_images, g_cams = scene(B, 3, 256, 320, 32, seed=20 + B)
        g_ds, g_di, _, g_de = depth_params_from_cams(g_cams)
        gru_in[B] = (g_images, g_cams, g_ds, g_di, g_de)
        per_map = [g_pred.predict(*(a[i:i + 1] for a in gru_in[B]))[:2] for i in range(B)]
        gru_ref[B] = tuple(np.concatenate(p, axis=0) for p in zip(*per_map))
    del g_pred
    # 8e's reference: the single-card refined Predictor, one call per map
    r_pred = Predictor(ModelConfig(**REFINE_MULTI_CFG_ARGS), seed=0, device=dev)
    refine_in, refine_ref = {}, {}
    for regime, B in (("latency", 1), ("throughput", n)):
        r_images, r_cams = scene(B, 3, 256, 320, 32, seed=30 + B)
        r_ds, r_di, _, r_de = depth_params_from_cams(r_cams)
        refine_in[regime] = (r_images, r_cams, r_ds, r_di, r_de)
        per_map = [r_pred.predict(*(a[i:i + 1] for a in refine_in[regime])) for i in range(B)]
        refine_ref[regime] = tuple(np.concatenate(p, axis=0) for p in zip(*per_map))
    del r_pred
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    results = spawn(phase8_rank, n, backend, backend, serve_in, batch_in, t_batch, gru_in,
                    refine_in, two if n == 2 else None)
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
    for B, (want_depth, want_prob) in gru_ref.items():
        per_rank = -(-B // n)                  # maps a rank runs once B is padded to n
        equal = all(np.array_equal(r["gru"][B]["depth"], want_depth)
                    and np.array_equal(r["gru"][B]["prob"], want_prob) for r in results)
        k1 = [r["gru"][B]["cost_volume"] for r in results]
        good = equal and all(k == per_rank for k in k1)
        ok = ok and good
        walls = ", ".join(f"{r['gru'][B]['wall']:.2f}" for r in results)
        padding = f"padded to {n}" if B % n else "no padding"
        print(f"  8d: R-MVSNet throughput serving, B={B} ({padding}), 320x256, D=32, V=3, "
              f"normal, bf16: wall ms per rank {walls} (a rank's first includes its "
              f"capture); depth and prob equal bit for bit to the single-card Predictor, one "
              f"call per map: {equal}; K1 launches per rank {k1} (expected {per_rank}) "
              f"{'ok' if good else 'FAIL'} [{smi}]")
    for regime, (want_d, want_p, want_r) in refine_ref.items():
        got = [r["refined"][regime] for r in results]
        r_tol = REFINE_RESIDUAL_TOL * max(1.0, float(np.abs(want_r).max()))
        d_err = max(float(np.abs(g["depth"] - want_d).max()) for g in got)
        p_err = max(float(np.abs(g["prob"] - want_p).max()) for g in got)
        r_err = max(float(np.abs(g["residual"] - want_r).max()) for g in got)
        equal = d_err == p_err == r_err == 0
        k1 = [g["counts"]["cost_volume_sharded" if regime == "latency" else "cost_volume"]
              for g in got]
        # throughput: each rank runs the single-card forward on its map, so
        # bit for bit; latency: the depth-sharded U-Net, within phase 5's bounds
        good = (k1 == [1] * n and (equal if regime == "throughput" else
                                   d_err <= E2E_DEPTH_ATOL and p_err <= E2E_PROB_ATOL
                                   and r_err <= r_tol))
        ok = ok and good
        bound = ("bit for bit" if regime == "throughput" else
                 f"bounds {E2E_DEPTH_ATOL:g} / {E2E_PROB_ATOL:g} / {r_tol:.3e}")
        print(f"  8e: refined serving, {regime} regime, B={len(want_d)}, 320x256, D=32, V=3, "
              f"normal, f32, U-Net upsampled with confidence: wall ms per rank "
              f"{', '.join(f'{g['wall']:.2f}' for g in got)}; vs the single-card Predictor, one "
              f"call per map: refined depth max abs err {d_err:.3e}, prob {p_err:.3e}, residual "
              f"{r_err:.3e} ({bound}); K1{'s' if regime == 'latency' else ''} launches per rank "
              f"{k1} (expected 1) {'ok' if good else 'FAIL'} [{smi}]")
    dry = [r["gru_dryrun"] for r in results]
    print(f"  8d: entry.gru_dryrun (ultralite GRU 64x64 D=8 f32) on every rank: batch {dry} "
          f"(expected {max(1, n - 1)}) {'ok' if dry == [max(1, n - 1)] * n else 'FAIL'}")
    ok = ok and dry == [max(1, n - 1)] * n
    if not ok:
        print("phase 8 FAILED")
        return None
    return (sum(r["latency"]["total"]["cost_volume_sharded"] for r in results),
            {"latency": ref["latency"], "step": ref_step},
            [r["blocks"] for r in results] if "blocks" in results[0] else None)


def phase8_rank(backend, serve_in, batch_in, train_batch, gru_in, refine_in, two=None):
    """One rank of phase 8 (started by `parallel.launch.spawn`): serving in
    the latency (B=1) and throughput (B=n) regimes through the default
    multi-device `Predictor`, GRU throughput serving on each batch of
    `gru_in` and the dry run's GRU regime, then one sharded f32 train step.
    Returns numpy results, launch counts and timings."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.entry import gru_dryrun
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

        def timed_exchange(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = exchange(*args)
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

    # ---- 8d: GRU throughput serving (padded where B % n), the dry run's regime
    g_pred = Predictor(ModelConfig(**GRU_MULTI_CFG_ARGS), seed=0)
    out["gru"] = {}
    for B, inputs in gru_in.items():
        before = kernels.launch_counts()["cost_volume"]
        torch.distributed.barrier()
        t0 = time.perf_counter()
        depth, prob, _ = g_pred.predict(*inputs, fetch=False)
        torch.cuda.synchronize()
        out["gru"][B] = dict(wall=(time.perf_counter() - t0) * 1e3,
                             cost_volume=kernels.launch_counts()["cost_volume"] - before,
                             depth=depth.cpu().numpy(), prob=prob.cpu().numpy())
    out["gru_dryrun"] = gru_dryrun(g_pred.mesh)
    del g_pred
    torch.cuda.empty_cache()

    # ---- 8e: refined serving in both regimes
    r_pred = Predictor(ModelConfig(**REFINE_MULTI_CFG_ARGS), seed=0)
    out["refined"] = {}
    for regime, inputs in refine_in.items():
        before = kernels.launch_counts()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        depth, prob, residual = r_pred.predict(*inputs, fetch=False)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        out["refined"][regime] = dict(
            wall=(time.perf_counter() - t0) * 1e3, counts={k: after[k] - before[k] for k in after},
            depth=depth.cpu().numpy(), prob=prob.cpu().numpy(), residual=residual.cpu().numpy())
    del r_pred
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
    if two is not None:           # 8g and 8h's two-rank work, in this world
        del m, state
        torch.cuda.empty_cache()
        out["blocks"] = blocks_two(backend, *two)
    return out


def blocks_backend(n):
    """The backend of a blocked phase's world of n ranks: one NCCL rank per
    card where there are n cards, else n gloo-cuda ranks on one card (the
    `serving_setup` pattern)."""
    return "nccl" if torch.cuda.device_count() >= n else "gloo-cuda"


def small_train_setup(regularization="3DCNN"):
    """8c's and 8g's float32 point (128x128, D=16, B=2, seeded weights,
    norms perturbed; the GRU "ultralite" for 8h): config, model, batch."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet

    gru = regularization == "GRU"
    cfg = ModelConfig(view_num=3, max_d=16, width=128, height=128,
                      network_mode="ultralite" if gru else "normal",
                      regularization=regularization, compute_dtype="float32")
    batch = tuple(np.concatenate(parts, axis=0) for parts in
                  zip(*[train_scene(128, 128, 16, seed) for seed in (3, 8)]))
    m = MVSNet(cfg, seed=3)
    perturb_norms(m, seed=4)
    return cfg, m, batch


def step_record(model, metrics):
    return (metrics["loss"].item(), {k: p.grad.cpu().numpy() for k, p in model.named_parameters()},
            {k: b.cpu().numpy() for k, b in model.named_buffers()})


BIG_TRAIN_ARGS = dict(view_num=3, max_d=192, width=640, height=480, network_mode="normal",
                      compute_dtype="bfloat16")
BLOCK_SERVE_ARGS = dict(view_num=3, max_d=192, width=1152, height=864, network_mode="normal",
                        compute_dtype="bfloat16")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else float("nan")


def gib(n_bytes) -> str:
    """Bytes as GiB, or "not measured" where this run did not take them
    (--multi skips phases 4 and 6)."""
    return "not measured" if n_bytes is None or n_bytes != n_bytes else f"{n_bytes / 2 ** 30:.3f} GiB"


class _Clock:
    """A point in time: a CUDA event on a card, the host clock on the CPU
    (the rehearsal on CPU ranks). Synchronize before reading `ms_to`."""

    def __init__(self, dev):
        self.event = torch.cuda.Event(enable_timing=True) if dev.type == "cuda" else None
        self.t = None

    def record(self):
        if self.event is not None:
            self.event.record()
        else:
            self.t = time.perf_counter()
        return self

    def ms_to(self, later):
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3


class _Timed:
    """For the length of a `with` block, each (owner, attribute) of
    `targets` is wrapped so that each call is timed alone (a synchronize
    either side); `spent[attribute]` lists the calls' ms. A module's
    function (`halo.exchange`, `feature_net.norm_sum`) is replaced where
    its callers look it up; a mesh's method on the instance, so that the
    autograd functions' backwards, which call it, are timed too."""

    def __init__(self, dev, targets):
        self.dev, self.targets = dev, targets
        self.spent = {attr: [] for _, attr in targets}

    def _wrap(self, fn, into):
        def timed(*args, **kwargs):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(self.dev)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def __enter__(self):
        self.saved = [(owner, attr, vars(owner).get(attr)) for owner, attr in self.targets]
        for owner, attr in self.targets:
            setattr(owner, attr, self._wrap(getattr(owner, attr), self.spent[attr]))
        return self.spent

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        return False


def tower_profile(model, mesh, images, rows, train):
    """The feature tower alone on this rank's rows of the images (B, V, H,
    W, 3) (`MVSNet.extract_features` with `rows` over 'space'), eval or
    with `train` forward and backward (the backward of a fixed linear
    function of the features): the stages' ms by CUDA events after a
    warm-up call, and the peak; then one call with every collective timed
    alone: forward, the exchanges (`halo.exchange`) and the norms' sums
    (`feature_net.norm_sum`); backward, the mesh's all_gathers (the
    exchanges' halo cotangents going home) and all_reduces (the sums'
    cotangents); every tensor of one forward recorded: the whole (B·V,
    H/2^l, W/2^l, C) maps (none) and the largest but the images; whether
    the tower split
    (no whole-tower warning). Returns numpy and Python values."""
    import contextlib
    import logging

    from mvsnet_tpu_torch.models import feature_net
    from mvsnet_tpu_torch.parallel import halo
    from mvsnet_tpu_torch.parallel.rank_checks import ShapeAudit, whole_tower_shapes

    dev = images.device
    B, V, H, W, _ = images.shape
    model.train(train)
    blocks = (mesh, rows)
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("mvsnet_tpu_torch").addHandler(handler)

    def forward():
        ref, views = model.extract_features(images, blocks)
        if not train:
            return ref, None
        return ref, (ref.float().mean() + views.float().mean()) * 1e3

    def backward(loss):
        loss.backward()
        for p in model.parameters():
            p.grad = None

    out = {}
    try:
        with contextlib.nullcontext() if train else torch.inference_mode():
            ref, loss = forward()                          # warm-up
            if train:
                backward(loss)
            _sync(dev)
            _reset_peak(dev)
            clocks = [_Clock(dev) for _ in range(3)]
            torch.distributed.barrier()
            clocks[0].record()
            ref, loss = forward()
            clocks[1].record()
            if train:
                backward(loss)
            clocks[2].record()
            _sync(dev)
            out["peak"] = _peak(dev)
            out["forward_ms"] = clocks[0].ms_to(clocks[1])
            out["backward_ms"] = clocks[1].ms_to(clocks[2]) if train else None
            out["rows"] = tuple(ref.shape[1:3])
            torch.distributed.barrier()
            with _Timed(dev, [(halo, "exchange"), (feature_net, "norm_sum")]) as fwd:
                ref, loss = forward()
            bwd = {"all_gather": [], "all_reduce": []}
            if train:
                with _Timed(dev, [(mesh, "all_gather"), (mesh, "all_reduce")]) as bwd:
                    backward(loss)
            with ShapeAudit() as seen:
                forward()
    finally:
        logging.getLogger("mvsnet_tpu_torch").removeHandler(handler)
    model.eval()
    out.update(exchanges=fwd["exchange"], norm_sums=fwd["norm_sum"],
               backward_gathers=bwd["all_gather"], backward_reduces=bwd["all_reduce"],
               whole_maps=whole_tower_shapes(seen.shapes, B * V, H, W),
               largest=max((sh for sh in seen.shapes if not (sh[-1:] == (3,) and H in sh)),
                           key=lambda sh: int(np.prod(sh))),
               whole_tower=[m for m in records if "UNetDS2GN" in m],
               sums_a_call=31 if model.feature_net.dtype in (torch.bfloat16,
                                                             torch.float16) else 62)
    return out


def tower_text(t) -> str:
    """One rank's `tower_profile` as a line."""
    text = f"tower {t['forward_ms']:.3f} ms forward"
    if t["backward_ms"] is not None:
        text += f", {t['backward_ms']:.3f} ms backward"
    text += (f" (CUDA events, rows {t['rows'][0]} of the features); exchanges "
             f"{len(t['exchanges'])} taking {sum(t['exchanges']):.3f} ms, norm sums "
             f"{len(t['norm_sums'])} taking {sum(t['norm_sums']):.3f} ms (each timed alone)")
    if t["backward_ms"] is not None:
        text += (f"; backward all_gathers {len(t['backward_gathers'])} taking "
                 f"{sum(t['backward_gathers']):.3f} ms, all_reduces "
                 f"{len(t['backward_reduces'])} taking {sum(t['backward_reduces']):.3f} ms")
    return (text + f"; largest tower tensor {t['largest']}; whole tower maps "
            f"{t['whole_maps'] or 'none'}; peak {gib(t['peak'])}")


def tower_ok(t, train) -> bool:
    """The split was taken (no whole-tower warning), no rank held a whole
    tower map, and the collectives are the split tower's: 30 exchanges and
    the norms' sums (31 in bfloat16, 62 in float32) forward, as many
    backward."""
    sums = t["sums_a_call"]
    good = (not t["whole_tower"] and not t["whole_maps"] and len(t["exchanges"]) == 30
            and len(t["norm_sums"]) == sums)
    if train:
        good = good and len(t["backward_gathers"]) == 30 and len(t["backward_reduces"]) == sums
    return good


# the ultralite GRU's leaves whose gradient vanishes analytically: the
# biases before a one-channel layer norm (conv_gru3's gates and output, one
# filter each) and prob_conv's before the softmax over depth
GRU_ULTRALITE_VANISHING = ("gru_sweep.gru.prob_conv.bias",
                           "gru_sweep.gru.conv_gru3.gates_conv.bias",
                           "gru_sweep.gru.conv_gru3.output_conv.bias")


def phase8_blocks(smi, dev, request, peaks, serve_args=BLOCK_SERVE_ARGS,
                  big_args=BIG_TRAIN_ARGS, backend=None, refs=None, two=None):
    """8f, 8g, 8h: the volume in depth x space blocks over ranks
    (`parallel.infer_step.forward_3dcnn_blocks`, the blocked train step),
    in a world of 4 ranks ((1,2,2): serving and the f32 step) and one of 2
    ((1,2,1): the f32 and bf16 steps; (1,1,2): the GRU step), against the
    single card. Returns the launch counts of 8g's bf16 steps summed over
    the ranks, or None on failure. `serve_args` and `big_args` are the
    points (small ones with backend "gloo" run the phase on CPU ranks); `refs`
    8b's references (phase 4's latency answer, 8c's step), `two` the
    two-rank work's results where 8b's world of two ran it."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.parallel.launch import spawn
    from mvsnet_tpu_torch.predict import Predictor

    refs = dict(refs or {})
    if "latency" not in refs:
        predictor = Predictor(ModelConfig(**serve_args), seed=0, device=dev)
        refs["latency"] = predictor.predict(*request)[:2]
        del predictor
    ref = refs["latency"]
    steps = {"3DCNN": refs.get("step"), "GRU": None}      # the single-card steps
    for reg in [r for r, have in steps.items() if have is None]:
        s_cfg, m, s_batch = small_train_setup(reg)
        st = train_lib.create_train_state(m, s_cfg, TrainConfig(), device=dev)
        _, met = train_lib.make_train_step(m, s_cfg, TrainConfig())(st, s_batch)
        steps[reg] = step_record(m, met)
        del m, st, met
    b_cfg = ModelConfig(**big_args)
    H, W, D = b_cfg.height, b_cfg.width, b_cfg.max_d
    big_batch = train_scene(H, W, D, seed=2)
    single = expected_train_launches(MVSNet(b_cfg, seed=0), b_cfg, H // 4, W // 4)
    # the blocked step on (1,2,1): the same convs (halo-extended inputs),
    # K1s forward and K2/K3 on the block backward, per depth slab of D / 2
    chunks_block = max(1, -(-(3 * D // 2 * H // 4 * W // 4 * 32 * 4) // (2 * 1024 ** 3)))
    want_big = dict(single, cost_volume=0, cost_volume_sharded=1, warp=0, warp_transpose=0,
                    warp_sharded=2 * chunks_block, warp_transpose_sharded=2 * chunks_block)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ok, counts = True, None
    for n in (4, 2):
        backend_n = backend or blocks_backend(n)
        where = (f"{n} NCCL ranks, one per card" if backend_n == "nccl" else
                 f"{n} ranks on one card over gloo, collectives staged through host memory")
        t0 = time.perf_counter()
        if n == 2 and two is not None:
            results = two
            where += ", 8b's world"
        else:
            results = spawn(phase8_blocks_rank, n, backend_n, backend_n, request, big_batch,
                            serve_args, big_args)
        print(f"phase 8{'f/8g' if n == 4 else 'g/8h'}: depth x space blocks, {where}: started, "
              f"ran and joined in {time.perf_counter() - t0:.1f} s [{smi}]")
        for key, r0 in results[0].items():
            if key == "serve":
                d_err = max(float(np.abs(r["serve"]["depth"] - ref[0]).max()) for r in results)
                p_err = max(float(np.abs(r["serve"]["prob"] - ref[1]).max()) for r in results)
                k1s = [[c["cost_volume_sharded"] for c in r["serve"]["counts"]] for r in results]
                k1 = [[c["cost_volume"] for c in r["serve"]["counts"]] for r in results]
                convs = [[(c["conv"], c["deconv"]) for c in r["serve"]["counts"]]
                         for r in results]
                want_convs = (EXPECTED_LAUNCHES["conv"], EXPECTED_LAUNCHES["deconv"])
                whole = [r["serve"]["whole"] for r in results]
                towers = [r["serve"]["tower"] for r in results]
                split = all(not r["serve"]["whole_tower"] and tower_ok(t, False)
                            for r, t in zip(results, towers))
                good = (d_err <= E2E_DEPTH_ATOL and p_err <= E2E_PROB_ATOL
                        and all(k == [1, 1, 1] for k in k1s) and all(k == [0, 0, 0] for k in k1)
                        and all(c == [want_convs] * 3 for c in convs) and split
                        and not any(whole) and all(r["serve"]["finite"] for r in results))
                ok = ok and good
                print(f"  8f: latency serving on {r0['mesh']}, {serve_args['width']}x"
                      f"{serve_args['height']}, D={serve_args['max_d']}, V=3, "
                      f"{serve_args['network_mode']}, {serve_args['compute_dtype']}, 3 requests: "
                      f"vs phase 4's single-card Predictor depth max "
                      f"abs err {d_err:.3e} (bound {E2E_DEPTH_ATOL:g}), prob {p_err:.3e} "
                      f"(bound {E2E_PROB_ATOL:g}); K1s launches per rank and request {k1s} "
                      f"(expected 1), K1 {k1}; conv and deconv launches per rank and request "
                      f"{convs} (expected {want_convs}: the tower's and the U-Net's halo "
                      f"convs, one launch each); whole (D, h, w) tensors per rank {whole}; the "
                      f"tower split over 'space' on every rank (no whole-tower warning, no "
                      f"whole tower map, 30 exchanges and {towers[0]['sums_a_call']} norm sums "
                      f"a call): {split} "
                      f"{'ok' if good else 'FAIL'} [{smi}]")
                for i, r in enumerate(results):
                    sv = r["serve"]
                    print(f"    rank {i} {sv['coords']}: wall ms per request "
                          f"{', '.join(f'{w:.2f}' for w in sv['walls'])} (the first includes "
                          f"set-up); stages (ms, host clock after a synchronize) "
                          + ", ".join(f"{k} {v:.3f}" for k, v in sv["stages"].items())
                          + "; stages (ms, CUDA events) "
                          + ", ".join(f"{k} {v:.3f}" for k, v in sv["stage_events"].items())
                          + f"; halo exchanges {sv['halo_count']} taking {sv['halo_ms']:.3f} ms "
                          f"(each timed alone), of which the tower's {sv['tower_halo']['exchanges']} "
                          f"taking {sv['tower_halo']['ms']:.3f} ms and the U-Net's "
                          f"{sv['halo_count'] - sv['tower_halo']['exchanges']} taking "
                          f"{sv['halo_ms'] - sv['tower_halo']['ms']:.3f} ms; the tower's norm "
                          f"sums {sv['norm_sums'][0]} taking {sv['norm_sums'][1]:.3f} ms; peak "
                          f"memory {gib(sv['peak'])} (phase 4's single card: "
                          f"{gib(peaks.get('serve'))}); largest tensor "
                          f"{sv['largest']} [{smi}]")
                    print(f"      the tower alone, eval: {tower_text(sv['tower'])} [{smi}]")
            elif key.startswith("small"):
                reg = "GRU" if key.endswith("gru") else "3DCNN"
                for i, r in enumerate(results):
                    t = r[key]
                    good, text = step_errors(
                        (t["loss"], t["grads"], t["buffers"]), steps[reg],
                        vanishing=GRU_ULTRALITE_VANISHING if reg == "GRU" else ())
                    ok = ok and good
                    what = ("8h: R-MVSNet train step, ultralite" if reg == "GRU" else
                            "8g: train step, normal")
                    print(f"  {what} f32 128x128 D=16 B=2 on {t['mesh']}, rank {i}, vs the "
                          f"single-card step: {text}")
            elif key.startswith("big"):
                per_step = [r[key]["counts"] for r in results]
                towers = [r[key].get("tower") for r in results]
                good = (all(c == want_big for st in per_step for c in st)
                        and all(r[key]["finite"] for r in results)
                        and all(t is None or tower_ok(t, True) for t in towers))
                ok = ok and good
                print(f"  8g: blocked train steps on {r0['mesh']}, {W}x{H}, D={D}, V=3, "
                      f"{b_cfg.network_mode}, {b_cfg.compute_dtype}, rmsprop, power + gradient "
                      f"loss: losses "
                      f"{[round(v, 4) for v in r0['losses']]}; launches per step, rank "
                      f"0: {per_step[0][0]}; expected per rank {want_big}"
                      + (f"; the tower split over 'space' on every rank (30 exchanges and "
                         f"{towers[0]['sums_a_call']} norm sums forward, as many backward, no "
                         f"whole tower map)" if towers[0] is not None else "")
                      + f" {'ok' if good else 'FAIL'} [{smi}]")
                for i, r in enumerate(results):
                    print(f"    rank {i}: step ms {', '.join(f'{w:.2f}' for w in r[key]['walls'])}"
                          f" (the first includes set-up); peak memory {gib(r[key]['peak'])} "
                          f"(phase 6's single card: {gib(peaks.get('train'))}) [{smi}]")
                    if towers[i] is not None:
                        print(f"      the tower alone, training: {tower_text(towers[i])} [{smi}]")
                if key == "big":
                    counts = {k: sum(r["big"]["total"][k] for r in results)
                              for k in results[0]["big"]["total"]}
            elif key == "tower_112_gru":
                good = all(tower_ok(r[key], True) for r in results)
                ok = ok and good
                print(f"  8h: R-MVSNet's tower (lite) alone in training on (1,1,2), {W}x{H}: the "
                      f"split taken on every rank {'ok' if good else 'FAIL'} [{smi}]")
                for i, r in enumerate(results):
                    print(f"    rank {i}: {tower_text(r[key])} [{smi}]")
    if not ok:
        print("phase 8f-8h FAILED")
        return None
    return counts


def blocked_small_step(backend, shape, reg="3DCNN"):
    """One f32 blocked train step at `small_train_setup`'s point on a mesh
    of `shape`, as a `step_errors` record with the mesh."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import TrainConfig
    from mvsnet_tpu_torch.parallel.mesh import make_mesh
    from mvsnet_tpu_torch.parallel.train_step import make_sharded_train_step

    mesh = make_mesh(shape=shape, backend=backend)
    cfg, m, batch = small_train_setup(reg)
    state = train_lib.create_train_state(m, cfg, TrainConfig(), device=mesh.device)
    _, met = make_sharded_train_step(m, cfg, TrainConfig(), mesh)(state, batch)
    loss, grads, buffers = step_record(m, met)
    return dict(mesh=mesh.shape, loss=loss, grads=grads, buffers=buffers)


def phase8_blocks_rank(backend, serve_in, big_batch, serve_args, big_args):
    """One rank of 8f-8h (started by `parallel.launch.spawn`). In a world of
    4: latency serving on (1,2,2) (3 requests, stages, halos, peak, the
    tensors of one request audited, the tower alone), the f32 step and 3
    bf16 steps on (1,2,2) with the tower alone in training; in a world of
    2: the f32 step on (1,2,1), 3 bf16 steps on (1,2,1), the GRU's f32 step
    on (1,1,2) and its tower alone at the training point
    (`blocks_two`). Returns numpy results, counts and timings."""
    import logging

    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import feature_net
    from mvsnet_tpu_torch.models.regnet import plan_volume
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.parallel import halo
    from mvsnet_tpu_torch.parallel.infer_step import latency_forward
    from mvsnet_tpu_torch.parallel.mesh import make_mesh
    from mvsnet_tpu_torch.parallel.rank_checks import ShapeAudit, whole_volume_shapes
    from mvsnet_tpu_torch.predict import Predictor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world = torch.distributed.get_world_size()
    out = {}
    dev = make_mesh(shape=(1, world, 1), backend=backend).device

    if world == 4:
        cfg = ModelConfig(**serve_args)
        mesh = make_mesh(shape=(1, 2, 2), backend=backend)
        predictor = Predictor(cfg, seed=0, mesh=mesh, device=dev)
        records = []
        handler = logging.Handler()
        handler.emit = lambda record: records.append(record.getMessage())
        logging.getLogger("mvsnet_tpu_torch").addHandler(handler)
        walls, counts = [], []
        _sync(dev)
        _reset_peak(dev)
        try:
            for _ in range(3):
                before = kernels.launch_counts()
                torch.distributed.barrier()
                t0 = time.perf_counter()
                depth, prob, _ = predictor.predict(*serve_in, fetch=False)
                _sync(dev)
                walls.append((time.perf_counter() - t0) * 1e3)
                after = kernels.launch_counts()
                counts.append({k: after[k] - before[k] for k in after})
        finally:
            logging.getLogger("mvsnet_tpu_torch").removeHandler(handler)
        peak = _peak(dev)
        serve = dict(mesh=mesh.shape, coords=mesh.coords, walls=walls, counts=counts, peak=peak,
                     depth=depth.cpu().numpy(), prob=prob.cpu().numpy(),
                     finite=bool(torch.isfinite(depth).all() and torch.isfinite(prob).all()),
                     whole_tower=[m for m in records if "UNetDS2GN" in m])
        model = predictor.model
        args = tuple(torch.as_tensor(a, device=mesh.device) for a in serve_in[:4])
        marks = []

        def mark(name):
            _sync(dev)
            marks.append((name, time.perf_counter(), _Clock(dev).record()))
        tower_share = {}

        def note_tower(name):
            if name == "features":
                tower_share.update(exchanges=len(spent["exchange"]),
                                   ms=sum(spent["exchange"]))
        with torch.inference_mode():
            torch.distributed.barrier()
            mark("start")
            latency_forward(model, mesh, *args, on_stage=mark)
            _sync(dev)
            serve["stages"] = {name: (t - marks[i][1]) * 1e3
                               for i, (name, t, _) in enumerate(marks[1:])}
            serve["stage_events"] = {name: marks[i][2].ms_to(c)
                                     for i, (name, _, c) in enumerate(marks[1:])}
            with _Timed(dev, [(halo, "exchange"), (feature_net, "norm_sum")]) as spent:
                latency_forward(model, mesh, *args, on_stage=note_tower)
            serve["halo_ms"], serve["halo_count"] = sum(spent["exchange"]), len(spent["exchange"])
            serve["tower_halo"] = tower_share
            serve["norm_sums"] = (len(spent["norm_sum"]), sum(spent["norm_sum"]))
            with ShapeAudit() as seen:
                latency_forward(model, mesh, *args)
        serve["whole"] = whole_volume_shapes(seen.shapes, cfg.max_d, cfg.height // 4,
                                             cfg.width // 4)
        serve["largest"] = max(seen.shapes, key=lambda sh: int(np.prod(sh)))
        rows = plan_volume(mesh, cfg.max_d, cfg.height // 4).rows
        serve["tower"] = tower_profile(model, mesh, args[0], rows, train=False)
        out["serve"] = serve
        del predictor, model, args
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["small_122"] = blocked_small_step(backend, (1, 2, 2))
        out["big_122"] = big_steps(backend, (1, 2, 2), big_batch, big_args)
        return out

    return blocks_two(backend, big_batch, big_args)


def big_steps(backend, shape, big_batch, big_args):
    """8g's main path on a mesh of `shape`: 3 bf16 blocked train steps at
    `big_args`, timed, launches per step, the peak; where the mesh splits
    'space', then the tower alone in training (`tower_profile`)."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.parallel.mesh import AxisSplit, make_mesh
    from mvsnet_tpu_torch.parallel.train_step import make_sharded_train_step

    cfg = ModelConfig(**big_args)
    tcfg = TrainConfig()
    mesh = make_mesh(shape=shape, backend=backend)
    dev = mesh.device
    model = MVSNet(cfg, seed=0)
    state = train_lib.create_train_state(model, cfg, tcfg, device=dev)
    step = make_sharded_train_step(model, cfg, tcfg, mesh)
    _sync(dev)
    _reset_peak(dev)
    kernels.reset_launch_counts()
    walls, per_step, losses, finite = [], [], [], True
    for _ in range(3):
        before = kernels.launch_counts()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        state, metrics = step(state, big_batch)
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        after = kernels.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(metrics["loss"].item())
        finite = finite and np.isfinite(losses[-1]) and all(
            bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    out = dict(mesh=mesh.shape, walls=walls, counts=per_step, losses=losses,
               total=kernels.launch_counts(), peak=_peak(dev), finite=finite)
    del state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if mesh.axis_size("space") > 1:
        sp = mesh.axis_size("space")
        rows = AxisSplit("space", cfg.height // 4, sp, mesh.axis_index("space"))
        images = torch.as_tensor(big_batch[0], device=dev)
        out["tower"] = tower_profile(model, mesh, images, rows, train=True)
    return out


def blocks_two(backend, big_batch, big_args):
    """8g and 8h's work in a world of two ranks: the f32 step on (1,2,1), 3
    bf16 steps at `big_args` on (1,2,1), the GRU's f32 step on (1,1,2) and
    the GRU "lite" model's tower alone in training on (1,1,2) at
    `big_args`' size (the bench `train_gru` point)."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.parallel.mesh import AxisSplit, make_mesh

    out = {"small_121": blocked_small_step(backend, (1, 2, 1)),
           "big": big_steps(backend, (1, 2, 1), big_batch, big_args),
           "small_112_gru": blocked_small_step(backend, (1, 1, 2), "GRU")}
    mesh = make_mesh(shape=(1, 1, 2), backend=backend)
    cfg = ModelConfig(**dict(big_args, network_mode="lite", regularization="GRU"))
    model = MVSNet(cfg, seed=0).to(mesh.device)
    rows = AxisSplit("space", cfg.height // 4, 2, mesh.axis_index("space"))
    images = torch.as_tensor(big_batch[0], device=mesh.device)
    _sync(mesh.device)
    out["tower_112_gru"] = tower_profile(model, mesh, images, rows, train=True)
    return out


# phase 9a/b: the driver's command line at the bench train point; every run
# adds its own model dir, step limit and, when resuming, --ckpt_step
DRIVER_ARGS = ["--view_num", "3", "--max_d", "192", "--width", "640", "--height", "480",
               "--network_mode", "lite", "--compute_dtype", "bfloat16",
               "--optimizer", "rmsprop", "--loss_type", "power", "--grad_loss", "true",
               "--epoch", "1", "--snapshot", "4", "--train_steps_per_val", "3",
               "--val_batch_size", "2", "--loader_workers", "1", "--device", "cuda:0"]
DRIVER_PATH_KERNELS = ("cost_volume", "conv", "deconv", "warp", "warp_transpose", "wgrad")


def _state_arrays(tree):
    """{name: numpy array} of a checkpoint's model and optimizer state."""
    out = {f"model.{k}": v.cpu().numpy() for k, v in tree["model"].items()}
    for i, slot in tree["optimizer"]["state"].items():
        out.update({f"optimizer.{i}.{k}": torch.as_tensor(v).cpu().numpy()
                    for k, v in slot.items()})
    return out


def _first_difference(a, b):
    """The first entry where two `_state_arrays` differ in a bit, or None."""
    if a.keys() != b.keys():
        return f"keys {sorted(a.keys() ^ b.keys())[:3]}"
    return next((k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                 or a[k].tobytes() != b[k].tobytes()), None)


# 8i (--multi): the drivers as a user starts them on four cards, against one
# card's run of the same command: the training driver at 9a's point in
# float32 (so that one card bounds it tightly), a batch of 2 over the
# (2, 2, 1) mesh of four ranks, 3 steps; the serving drivers at phase 14's
# point, float32, one cluster
MULTI_TRAIN_ARGS = ["--view_num", "3", "--max_d", "192", "--width", "640", "--height", "480",
                    "--network_mode", "lite", "--compute_dtype", "float32",
                    "--optimizer", "rmsprop", "--loss_type", "power", "--grad_loss", "true",
                    "--batch_size", "2", "--epoch", "1", "--max_steps_per_epoch", "3",
                    "--snapshot", "1000", "--loader_workers", "1"]


def run_driver(module, args, nproc, timeout=900):
    """`python -m module args` in a fresh process from the repository root,
    or with nproc > 1 under `torch.distributed.run --standalone` as nproc
    ranks with `--num_devices nproc`: (exit code, ms, the output's tail).
    A rank's failure makes torch.distributed.run exit non-zero."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", module, *args]
    if nproc > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", "-m", module, *args, "--num_devices", str(nproc)]
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=timeout)
        rc, text = proc.returncode, proc.stdout[-1500:] + proc.stderr[-3000:]
    except subprocess.TimeoutExpired as e:
        rc, text = 124, f"timed out after {timeout} s: {e}"
    return rc, (time.perf_counter() - t0) * 1e3, text


def phase8i_drivers(smi, nproc=4, device="cuda:0", train_point=(480, 640, 192),
                    serve_point=(384, 512, 4, 192)):
    """8i: `python -m mvsnet_tpu_torch.train --num_devices nproc` and the
    serving drivers (`infer`, `test`) with `--num_devices nproc`, each under
    `torch.distributed.run` (NCCL, a rank a card), against the same command
    on one card (`device`; "cpu" with gloo ranks rehearses it at small
    points). Gates: every run's exit code 0; training: the first step's
    loss within phase 7's 1e-4 of one card's (the same weights and batch;
    the driver logs it to metrics.jsonl), every logged loss finite, the
    final checkpoint's parameters finite and its keys one card's; serving:
    every file read back as phase 14 does, the depth, prob and residual
    maps within phase 5's bounds of one card's, the results CSV's numbers
    within 1e-2 of max(1, |one card's|). Returns whether every gate held."""
    import re
    import shutil
    import tempfile

    from mvsnet_tpu_torch import checkpoint, train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.io.pfm import load_pfm
    from mvsnet_tpu_torch.models import MVSNet

    (H, W, D), (sH, sW, sV, sD) = train_point, serve_point
    print(f"phase 8i: the drivers on {nproc} ranks under torch.distributed.run "
          f"({'NCCL, a rank a card' if device != 'cpu' else 'gloo, CPU ranks'}) against one "
          f"{'card' if device != 'cpu' else 'process'}: train at {W}x{H}, D={D}, lite, float32, "
          f"batch 2, 3 steps; infer and test with refinement at {sW}x{sH}, V={sV}, D={sD}, "
          f"normal, float32, one cluster [{smi}]", flush=True)
    ok = True
    with tempfile.TemporaryDirectory(prefix="mvsnet_multi_drivers_") as root:
        data = os.path.join(root, "data")
        for k in (0, 1):
            write_rendered_session(os.path.join(data, "train", f"session_{k}"), W, H, 5, k)
        train_args = [*MULTI_TRAIN_ARGS, "--width", str(W), "--height", str(H), "--max_d",
                      str(D), "--train_data_root", data, "--device", device]
        runs = {}
        for n in (1, nproc):
            model_dir = os.path.join(root, f"train_{n}")
            runs[n] = run_driver("mvsnet_tpu_torch.train", train_args + ["--model_dir", model_dir],
                                 n) + (model_dir,)
        records, finals, losses = {}, {}, {}
        for n, (rc, ms, text, model_dir) in runs.items():
            path = os.path.join(model_dir, "metrics.jsonl")
            records[n] = ([json.loads(line) for line in open(path) if line.strip()]
                          if os.path.exists(path) else [])
            losses[n] = [float(x) for x in re.findall(r"loss=([-\d.e+naninf]+)", text)]
            step = checkpoint.latest_step(model_dir, "3DCNN", "lite") if rc == 0 else None
            finals[n] = (_state_arrays(checkpoint.restore_tree(model_dir, "3DCNN", "lite", step))
                         if step is not None else None)
        first = {n: r[0]["loss"] if r else float("nan") for n, r in records.items()}
        rel = abs(first[nproc] - first[1]) / max(abs(first[1]), 1e-12)
        good = (all(r[0] == 0 for r in runs.values()) and rel <= TRAIN_LOSS_RTOL
                and all(np.isfinite(v) for ls in losses.values() for v in ls)
                and all(f is not None for f in finals.values()))
        diff = None
        if good:
            a, b = ({k: v for k, v in f.items() if k.startswith("model.")}
                    for f in (finals[nproc], finals[1]))
            good = sorted(a) == sorted(b) and all(np.isfinite(v).all() for v in a.values())
            diff = (float(np.sqrt(sum(float(np.square(a[k] - b[k]).sum()) for k in b)
                                  / sum(float(np.square(b[k]).sum()) for k in b)))
                    if good else None)
        ok = ok and good
        print(f"  train: one {'card' if device != 'cpu' else 'process'} rc {runs[1][0]} in "
              f"{runs[1][1]:.1f} ms, {nproc} ranks rc {runs[nproc][0]} in {runs[nproc][1]:.1f} ms "
              f"(process start, set-up and 3 steps); first step's loss {first[nproc]:.6f} vs one's "
              f"{first[1]:.6f}: relative difference {rel:.3e} (bound {TRAIN_LOSS_RTOL:g}); the "
              f"steps' logged losses (a line a rank) {losses[nproc]} vs {losses[1]}; final "
              f"parameters' difference {diff if diff is None else f'{diff:.3e}'} of their norm "
              f"(3 RMSprop steps, whose sign-like first updates turn rounding-level gradient "
              f"differences into lr-sized ones; not bounded) {'ok' if good else 'FAIL'} [{smi}]")
        if not good:
            for n, r in runs.items():
                print(f"  --- {n} rank(s), output's tail:\n{r[2]}")

        # serving: a checkpoint, two copies of each session, one card and n ranks
        cfg = ModelConfig(view_num=sV, max_d=sD, width=sW, height=sH, network_mode="normal",
                          compute_dtype="float32", **REFINE_ARGS)
        state = train_lib.create_train_state(MVSNet(cfg, seed=0), cfg, TrainConfig(),
                                             device="cpu")
        model_dir = os.path.join(root, "models")
        checkpoint.save_checkpoint(model_dir, "3DCNN", "normal", 100, state)
        del state
        common = ["--view_num", str(sV), "--max_d", str(sD), "--width", str(sW), "--height",
                  str(sH), "--network_mode", "normal", "--compute_dtype", "float32",
                  "--refinement", "--refinement_network", "unet", "--refine_with_confidence",
                  "--visualize", "--model_dir", model_dir, "--ckpt_step", "100",
                  "--max_clusters_per_session", "1", "--device", device]
        write_rendered_session(os.path.join(root, "infer_1"), sW, sH, sV, 0)
        write_rendered_session(os.path.join(root, "bench_1", "test", "session_0"), sW, sH, sV, 1)
        shutil.copytree(os.path.join(root, "infer_1"), os.path.join(root, f"infer_{nproc}"))
        shutil.copytree(os.path.join(root, "bench_1"), os.path.join(root, f"bench_{nproc}"))
        maps, rows = {}, {}
        for n in (1, nproc):
            infer_dir, bench_dir = (os.path.join(root, f"{k}_{n}") for k in ("infer", "bench"))
            results = os.path.join(root, f"results_{n}.csv")
            r_infer = run_driver("mvsnet_tpu_torch.infer", ["--input_dir", infer_dir,
                                                            "--upsample_before_refinement",
                                                            *common], n)
            r_test = run_driver("mvsnet_tpu_torch.test", ["--input_dir", bench_dir,
                                                          "--results_path", results,
                                                          "--write_output", *common], n)
            runs[("infer", n)], runs[("test", n)] = r_infer, r_test
            for name, out_dir in (("infer", os.path.join(infer_dir, "depths_mvsnet")),
                                  ("test", os.path.join(bench_dir, "test", "session_0",
                                                        "depths_mvsnet"))):
                try:
                    first = sorted(f for f in os.listdir(out_dir) if f.endswith("_init.pfm"))
                    index = first[0][:-len("_init.pfm")]
                    maps[(name, n)] = {k: load_pfm(os.path.join(out_dir, f"{index}_{k}.pfm"))
                                       for k in ("init", "prob", "residual")}
                except (OSError, ValueError, IndexError) as e:
                    maps[(name, n)] = repr(e)
            rows[n] = (open(results).read().splitlines()[1:] if os.path.exists(results) else [])
        for name in ("infer", "test"):
            a, b = maps[(name, nproc)], maps[(name, 1)]
            rcs = (runs[(name, 1)][0], runs[(name, nproc)][0])
            read = isinstance(a, dict) and isinstance(b, dict)
            errs = ({k: float(np.abs(a[k] - b[k]).max()) for k in b}
                    if read and all(a[k].shape == b[k].shape for k in b) else
                    ([a, b] if not read else {k: (a[k].shape, b[k].shape) for k in b}))
            scale = max(1.0, float(np.abs(b["residual"]).max())) if read else 1.0
            good = (rcs == (0, 0) and read and all(a[k].shape == b[k].shape for k in b)
                    and all(np.isfinite(m).all() for m in a.values())
                    and errs["init"] <= E2E_DEPTH_ATOL and errs["prob"] <= E2E_PROB_ATOL
                    and errs["residual"] <= REFINE_RESIDUAL_TOL * scale)
            if name == "test":
                fa = [f for f in (rows[nproc][0].split(", ") if rows[nproc] else [])]
                fb = [f for f in (rows[1][0].split(", ") if rows[1] else [])]
                row_ok = (len(fa) == len(fb) == 6 and fa[:2] == fb[:2] and all(
                    abs(float(x) - float(y)) <= 1e-2 * max(1.0, abs(float(y)))
                    for x, y in zip(fa[2:], fb[2:])))
                good = good and row_ok
            ok = ok and good
            print(f"  {name}: one rc {rcs[0]} in {runs[(name, 1)][1]:.1f} ms, {nproc} ranks rc "
                  f"{rcs[1]} in {runs[(name, nproc)][1]:.1f} ms; refined depth, prob and "
                  f"residual vs one's: max abs err {errs} (bounds {E2E_DEPTH_ATOL:g}, "
                  f"{E2E_PROB_ATOL:g}, {REFINE_RESIDUAL_TOL:g} of {scale:.3g})"
                  + (f"; results CSV rows {rows[nproc]} vs {rows[1]}" if name == "test" else "")
                  + f" {'ok' if good else 'FAIL'} [{smi}]")
            if not good:
                for n in (1, nproc):
                    print(f"  --- {name}, {n} rank(s), output's tail:\n{runs[(name, n)][2]}")
    if not ok:
        print("phase 8i FAILED")
    return ok


def phase9_driver(smi, dev):
    """9a and 9b; returns whether every check held."""
    import os
    import tempfile

    from mvsnet_tpu_torch import checkpoint, train_lib
    from mvsnet_tpu_torch import train as driver
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels

    print("phase 9a: the training driver (mvsnet_tpu_torch.train.main) at 640x480, D=192, V=3, "
          "lite, bf16, rmsprop, power+grad loss, on plane scenes rendered by mvsnet_tpu_torch/"
          "data/synthetic.py and written to disk as sessions (JPEGs by the port's encoder); "
          "train.make_loader's ClusterGenerator reads them with the port's decoders; arguments, "
          "configs, the step, snapshots, validation and metrics run as a user runs them "
          f"[{smi}]")
    cfg = ModelConfig(view_num=3, max_d=192, width=640, height=480, network_mode="lite",
                      compute_dtype="bfloat16")
    ref = MVSNet(cfg)
    want_launches = expected_train_launches(ref, cfg, 120, 160)
    want_editions = expected_train_editions(ref, torch.bfloat16)
    del ref

    steps, saved, sample_ms = [], {}, []
    real = train_lib.make_train_step, driver.make_loader, checkpoint.save_checkpoint

    def loader_from(start):
        """train.make_loader over the sessions on disk; the train clusters
        start at the `start`-th. The driver restarts the data on resume (as
        JAX's does); this rotation makes the resumed run read the batches
        the straight run read next, so that the two runs can be compared.
        Each cluster's host time (decode and transforms) a sample is kept."""
        def make_loader(dcfg, tcfg, mode):
            inner = real[1](dcfg, tcfg, mode)

            def factory():
                gen = inner()
                k = start if mode == "train" else 0
                gen.clusters = gen.clusters[k:] + gen.clusters[:k]
                samples = gen.cluster_samples

                def timed(c):
                    t0 = time.perf_counter()
                    out = samples(c)
                    sample_ms.append((time.perf_counter() - t0) * 1e3 / max(1, len(out)))
                    return out
                gen.cluster_samples = timed
                return gen
            return factory
        return make_loader

    def counting_make_train_step(*args, **kwargs):
        step = real[0](*args, **kwargs)

        def counted(state, batch):
            before, ed_before = kernels.launch_counts(), kernels.edition_counts()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            after, ed_after = kernels.launch_counts(), kernels.edition_counts()
            steps.append(dict(wall=wall, loss=out[1]["loss"].item(),
                              launches={k: after[k] - before[k] for k in after},
                              editions={k: {e: n - ed_before[k][e] for e, n in v.items()}
                                        for k, v in ed_after.items()}))
            return out
        return counted

    def recording_save(base_dir, regularization, network_mode, step, state):
        saved[(base_dir, step)] = _state_arrays(
            {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict()})
        return real[2](base_dir, regularization, network_mode, step, state)

    ok = True
    with tempfile.TemporaryDirectory(prefix="mvsnet_driver_") as root:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        for split in ("train", "val"):                # a validation split: val rounds run
            for k in (0, 1):
                write_rendered_session(os.path.join(data, split, f"session_{k}"), 640, 480, 5, k)
        print(f"  wrote 2 train and 2 val sessions of 5 images at 640x480 in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        straight, resumed = os.path.join(root, "straight"), os.path.join(root, "resumed")

        def run(model_dir, start, *extra):
            driver.make_loader = loader_from(start)
            return driver.main(["--train_data_root", data, "--model_dir", model_dir,
                                *DRIVER_ARGS, *extra])

        train_lib.make_train_step, checkpoint.save_checkpoint = (counting_make_train_step,
                                                                 recording_save)
        try:
            kernels.reset_launch_counts()
            rcs = [run(straight, 0, "--max_steps_per_epoch", "6")]
            path_counts = kernels.launch_counts()
            straight_steps, straight_samples = list(steps), list(sample_ms)
            rcs.append(run(resumed, 0, "--max_steps_per_epoch", "4"))
            rcs.append(run(resumed, 4, "--max_steps_per_epoch", "2", "--ckpt_step", "4"))
        finally:
            train_lib.make_train_step, driver.make_loader, checkpoint.save_checkpoint = real
        with open(os.path.join(straight, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        walls = [st["wall"] for st in straight_steps]
        print(f"  6 steps: rc {rcs[0]}; step ms {', '.join(f'{w:.2f}' for w in walls)} (the first "
              f"includes set-up; steady median {np.median(walls[1:]):.2f} ms); losses "
              f"{', '.join(f'{st['loss']:.4f}' for st in straight_steps)} [{smi}]")
        print(f"  launches per step {straight_steps[-1]['launches']} (expected {want_launches}); "
              f"editions per step {straight_steps[-1]['editions']} (expected {want_editions})")
        print(f"  launches over the driver's run (6 steps and a validation round): {path_counts}")
        print(f"  the data plane (one producer thread, --loader_workers 1): host ms a sample "
              f"(JPEG decode of 3 views, depth PNG, transforms) median "
              f"{np.median(straight_samples):.2f}, max {max(straight_samples):.2f} over "
              f"{len(straight_samples)} clusters of the straight run; a batch of 1 against the "
              f"steady step's {np.median(walls[1:]):.2f} ms")
        print(f"  metrics.jsonl: {records}")
        bad_steps = [i for i, st in enumerate(steps) if st["launches"] != want_launches
                     or st["editions"] != want_editions]
        idle = [k for k in DRIVER_PATH_KERNELS if path_counts[k] == 0]
        has_val = any("val_loss" in r for r in records)
        finite = all(np.isfinite(st["loss"]) for st in steps)
        if rcs != [0, 0, 0] or bad_steps or idle or not has_val or not finite:
            print(f"phase 9a FAILED: rcs {rcs}, steps with other counts {bad_steps}, kernels that "
                  f"never launched {idle}, val metrics {has_val}, losses finite {finite}")
            ok = False

        # ---- 9b: 4 + resume + 2 == 6, bit for bit
        reg, mode = "3DCNN", "lite"
        final = {d: _state_arrays(checkpoint.restore_tree(d, reg, mode, 6))
                 for d in (straight, resumed)}
        same_final = _first_difference(final[straight], final[resumed])
        latest = checkpoint.latest_step(resumed, reg, mode)
        state = train_lib.create_train_state(MVSNet(cfg, seed=1), cfg, TrainConfig(), device=dev)
        checkpoint.restore_checkpoint(resumed, reg, mode, state, step=4)
        restored = _state_arrays({"model": state.model.state_dict(),
                                  "optimizer": state.optimizer.state_dict()})
        same_restored = _first_difference(restored, saved[(resumed, 4)])
        print(f"phase 9b: 4 steps + snapshot + --ckpt_step 4 + 2 steps vs 6 straight steps: "
              f"parameters, statistics and RMSprop state equal bit for bit: {same_final is None}"
              + ("" if same_final is None else f" (first difference {same_final})")
              + f"; latest_step {latest} (expected 6); the state restored on the card equals the "
              f"saved one bit for bit: {same_restored is None}"
              + ("" if same_restored is None else f" (first difference {same_restored})"))
        if same_final is not None or same_restored is not None or latest != 6:
            print("phase 9b FAILED")
            ok = False
        del state
        torch.cuda.empty_cache()
    return ok


def phase9_convergence(smi, dev):
    """9c: the port's convergence gate; returns whether it held."""
    import itertools

    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.data import batch_iterator
    from mvsnet_tpu_torch.data.synthetic import SyntheticGenerator, render_session
    from mvsnet_tpu_torch.models import MVSNet

    # tests/test_convergence.py:22-34: one session a plane depth, 4 images each
    sessions = [render_session(n_images=4, plane_depth_mm=d, seed=i)
                for i, d in enumerate((1700.0, 2000.0, 2300.0))]
    gen = SyntheticGenerator(sessions, view_num=3, image_width=64, image_height=64,
                             depth_num=16, base_image_size=32, mode="train", flip_cams=False)
    batches = list(batch_iterator(gen.iterate_once(), 1))
    cfg = ModelConfig(view_num=3, max_d=16, width=64, height=64, network_mode="ultralite",
                      compute_dtype="float32")
    tcfg = TrainConfig(optimizer="adam", base_lr=2e-3, loss_type="original", grad_loss=False)
    model = MVSNet(cfg, seed=0)
    state = train_lib.create_train_state(model, cfg, tcfg, device=dev)
    step = train_lib.make_train_step(model, cfg, tcfg)
    losses, l3s = [], []
    t0 = time.perf_counter()
    for b in itertools.islice(itertools.cycle(batches), 600):
        state, m = step(state, b)
        losses.append(m["loss"].item())
        l3s.append(m["less_three"].item())
    ms = (time.perf_counter() - t0) * 1e3 / 600
    first, last, l3 = np.mean(losses[:12]), np.mean(losses[-12:]), np.mean(l3s[-12:])
    ok = bool(last < 0.1 * first and l3 > 0.9)
    print(f"phase 9c: convergence gate, 600 adam steps, ultralite 64x64 D=16 f32, {len(batches)} "
          f"three-depth plane samples rendered in memory: mean loss of the first 12 steps "
          f"{first:.4f}, of the last 12 {last:.4f} (bound {0.1 * first:.4f}), mean <3px of the "
          f"last 12 {l3:.4f} (bound 0.9) {'ok' if ok else 'FAIL'}; {ms:.2f} ms a step (host "
          f"clock, .item() each step) [{smi}]")
    print_profile("convergence step", *profile_device(lambda: step(state, batches[0])))
    return ok


def serve_counted(predictor, request, n=3):
    """n requests, each timed on the host clock to a synchronize, with the
    launches per request by kernel and by edition. Returns (walls, launches,
    editions, whether every depth and prob was finite, the last depth and
    prob)."""
    from mvsnet_tpu_torch.ops import kernels

    walls, per_request, editions, finite = [], [], [], True
    for _ in range(n):
        before, ed_before = kernels.launch_counts(), kernels.edition_counts()
        t0 = time.perf_counter()
        depth, prob, _ = predictor.predict(*request, fetch=False)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after, ed_after = kernels.launch_counts(), kernels.edition_counts()
        per_request.append({k: after[k] - before[k] for k in after})
        editions.append({k: {e: m - ed_before[k][e] for e, m in v.items()}
                         for k, v in ed_after.items()})
        finite = finite and bool(torch.isfinite(depth).all() and torch.isfinite(prob).all())
    return walls, per_request, editions, finite, depth, prob


def phase10_gru_serving(smi, dev, request):
    """R-MVSNet serving at the shapes of `request` (images, cams, depth
    start, interval, end; main passes the bench `gru` point's 1600x1184,
    D=256); returns the launch counts of its 3 counted requests, or None on
    failure."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.ops.cost_volume import plane_sweep_cost_volume
    from mvsnet_tpu_torch.ops.geometry import depth_values
    from mvsnet_tpu_torch.predict import Predictor

    B, V, H, W, _ = request[0].shape
    cfg = ModelConfig(view_num=V, max_d=int(request[1][0, 0, 1, 3, 2]), width=W, height=H,
                      interval_scale=0.8, network_mode="normal", regularization="GRU",
                      compute_dtype="bfloat16")
    point = f"{W}x{H}, D={cfg.max_d}, V={V}"
    predictor = Predictor(cfg, seed=0, device=dev)
    model = predictor.model
    want_launches, want_editions = expected_serving(model, torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor.predict(*request, fetch=False)          # captures the depth step
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_request, editions, ok, depth, prob = serve_counted(predictor, request)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 10: R-MVSNet serving, GRU Predictor at {point}, normal, bf16: "
          f"first request {first_ms:.2f} ms (captures the depth step as a CUDA graph), then "
          f"wall ms {', '.join(f'{w:.2f}' for w in walls)}; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"depth {tuple(depth.shape)} in [{depth.min().item():.1f}, {depth.max().item():.1f}], "
          f"prob in [{prob.min().item():.4f}, {prob.max().item():.4f}] [{smi}]")
    print(f"  launches per request {per_request[-1]} (expected {want_launches}); editions "
          f"{editions[-1]} (expected {want_editions})")
    idle = [k for k in ("cost_volume", "conv", "deconv") if counts[k] == 0]
    if (not ok or idle or any(r != want_launches for r in per_request)
            or any(e != want_editions for e in editions)):
        print(f"phase 10 FAILED: finite {ok}, kernels never launched {idle}, launches per "
              f"request {per_request}, editions {editions}")
        return None

    # one request stage by stage (CUDA events), then one profiled
    args = [torch.as_tensor(a, device=dev) for a in request]
    with torch.inference_mode():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ds, de = args[2], args[4]
        di = (de - ds) / (cfg.max_d - 1)
        ev[0].record()
        ref_f, view_f = model.extract_features(args[0])
        ev[1].record()
        cost = plane_sweep_cost_volume(ref_f, view_f, model.homographies(args[1], ds, di, de))
        ev[2].record()
        samples = depth_values(ds, di, cfg.max_d)
        regs_g, carry_g = model.gru_sweep(cost, samples)
        ev[3].record()
        max_prob, _, exp_sum = carry_g
        max_prob / (exp_sum + 1e-7)
        ev[4].record()
        torch.cuda.synchronize()
    names = ["feature_net", "homographies + cost_volume",
             f"gru sweep (graph, {cfg.max_d} replays)", "prob_map"]
    print("  stages (ms, CUDA events, one request): " + ", ".join(
        f"{n} {ev[i].elapsed_time(ev[i + 1]):.3f}" for i, n in enumerate(names)))
    # the profiler's kernel launches against the wrappers' counts: most of
    # them are CUDA-graph replays, counted from the capture
    before = kernels.launch_counts(), kernels.edition_counts()
    profile = profile_device(lambda: predictor.predict(*request, fetch=False))
    after = kernels.launch_counts(), kernels.edition_counts()
    print_profile("GRU request", *profile)
    seen, counted = profiled_launches(profile[2]), counted_launches(before, after)
    print(f"  kernels launched in the profiled request: profiler {seen}, wrappers' counts "
          f"{counted}")
    if profile[1] is None or seen != counted:
        print("phase 10 FAILED: the profiler saw other launches than the counts")
        return None

    # the graph-replayed sweep against the eager sweep, same cost volume
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        regs_e, carry_e = model.gru_sweep.eager(cost, samples)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        regs_g, carry_g = model.gru_sweep.graphed(cost, samples)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(regs_g, regs_e) and all(torch.equal(a, b) for a, b in zip(carry_g, carry_e))
    print(f"  sweep of {cfg.max_d} planes on one cost volume: graph-replayed {graph_ms:.2f} ms, "
          f"eager "
          f"{eager_ms:.2f} ms (host clock to a synchronize); regs, depth and the "
          f"winner-take-all sums equal bit for bit: {same} [{smi}]")
    del predictor, model, cost, regs_g, regs_e, carry_g, carry_e, ref_f, view_f, args
    torch.cuda.empty_cache()
    if not same:
        print("phase 10 FAILED: the graph-replayed sweep differs from the eager sweep")
        return None

    # card against CPU at 320x256, D=32, float32
    small = ModelConfig(view_num=3, max_d=32, width=320, height=256, network_mode="normal",
                        regularization="GRU", compute_dtype="float32")
    s_images, s_cams = scene(1, 3, 256, 320, 32, seed=11)
    s_args = (s_images, s_cams, s_cams[:, 0, 1, 3, 0], None, s_cams[:, 0, 1, 3, 3])
    out = {}
    for device in (dev, "cpu"):
        m = MVSNet(small, seed=1)
        perturb_norms(m, seed=2)
        m = m.to(device).eval()
        with torch.inference_mode():
            out[str(device)] = [o.cpu() for o in m.forward_gru_wta(
                *(None if a is None else torch.as_tensor(a, device=device) for a in s_args),
                with_regs=True)]
    (d_g, p_g, r_g), (d_c, p_c, r_c) = out[str(dev)], out["cpu"]
    tol = GRU_REGS_TOL * max(1.0, r_c.abs().max().item())
    r_err = (r_g - r_c).abs().max().item()
    top2 = r_c.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1] > tol)[..., None]
    d_same = torch.equal(d_g[decided], d_c[decided])
    p_err = (p_g - p_c).abs().max().item()
    good = r_err <= tol and d_same and p_err <= E2E_PROB_ATOL and bool(torch.isfinite(d_g).all())
    print(f"  R-MVSNet 320x256 D=32 normal f32, card (graph) vs CPU: regs max abs err {r_err:.3e} "
          f"(bound {tol:.3e}); depth equal at the {int(decided.sum())} of {decided.numel()} "
          f"pixels whose top two regs differ by more: {d_same}; prob max abs err {p_err:.3e} "
          f"(bound {E2E_PROB_ATOL:g}) {'ok' if good else 'FAIL'}")
    return counts if good else None


def phase11_gru_training(smi, dev, point=(480, 640, 192)):
    """R-MVSNet training at `point` (height, width, D; main passes the bench
    `train_gru` point's); returns the launch counts of its 3 counted steps,
    or None on failure."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels

    H, W, D = point
    cfg = ModelConfig(view_num=3, max_d=D, width=W, height=H, network_mode="lite",
                      regularization="GRU", compute_dtype="bfloat16")
    tcfg = TrainConfig()
    t_batch = train_scene(H, W, D, seed=12)
    model = MVSNet(cfg, seed=0)
    want = expected_train_launches(model, cfg, H // 4, W // 4)
    want_ed = expected_train_editions(model, torch.bfloat16)
    state = train_lib.create_train_state(model, cfg, tcfg, device=dev)
    step = train_lib.make_train_step(model, cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_step, per_ed, losses = [], [], [], []
    for _ in range(3):
        before, ed_before = kernels.launch_counts(), kernels.edition_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, t_batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after, ed_after = kernels.launch_counts(), kernels.edition_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        per_ed.append({k: {e: n - ed_before[k][e] for e, n in v.items()}
                       for k, v in ed_after.items()})
        losses.append(metrics["loss"].item())
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(v) for v in losses) and all(
        bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    print(f"phase 11: R-MVSNet training, 3 steps at {W}x{H}, D={D}, V=3, lite, bf16, rmsprop, "
          f"classification loss: step ms {', '.join(f'{w:.2f}' for w in walls)} (the first "
          f"includes set-up); peak memory {peak / 2 ** 30:.3f} GiB; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; <1 {metrics['less_one'].item():.4f} [{smi}]")
    print(f"  launches per step {per_step[-1]} (expected {want}); editions {per_ed[-1]} "
          f"(expected {want_ed})")
    idle = [k for k in DRIVER_PATH_KERNELS if counts[k] == 0]
    if (not finite or idle or any(r != want for r in per_step)
            or any(e != want_ed for e in per_ed)):
        print(f"phase 11 FAILED: finite {finite}, kernels never launched {idle}, launches "
              f"{per_step}, editions {per_ed}")
        return None

    # one step stage by stage, then one profiled
    batch = train_lib.to_device(t_batch, dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    state.optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    loss, _ = train_lib.compute_loss(model, cfg, tcfg, batch, training=True)
    ev[1].record()
    loss.backward()
    ev[2].record()
    train_lib.apply_gradients(state, tcfg)
    ev[3].record()
    torch.cuda.synchronize()
    print("  stages (ms, CUDA events, one step): " + ", ".join(
        f"{n} {ev[i].elapsed_time(ev[i + 1]):.3f}"
        for i, n in enumerate(["forward", "backward", "optimizer"])))
    print_profile("GRU train step (lite)", *profile_device(lambda: step(state, t_batch)))
    del state, model, step, batch, loss
    torch.cuda.empty_cache()

    # two "normal" steps at the same point
    n_cfg = dataclasses.replace(cfg, network_mode="normal")
    model = MVSNet(n_cfg, seed=0)
    state = train_lib.create_train_state(model, n_cfg, tcfg, device=dev)
    step = train_lib.make_train_step(model, n_cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, t_batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    finite = np.isfinite(metrics["loss"].item())
    print(f"  normal: 2 steps at {W}x{H}, D={D}, bf16: step ms "
          f"{', '.join(f'{w:.2f}' for w in walls)} (the first includes set-up); peak memory {peak / 2 ** 30:.3f} GiB; loss "
          f"{metrics['loss'].item():.4f} [{smi}]")
    del state, model, step
    torch.cuda.empty_cache()

    # one float32 step at 128x128, D=16: card vs CPU, and two card steps
    s_cfg = ModelConfig(view_num=3, max_d=16, width=128, height=128, network_mode="normal",
                        regularization="GRU", compute_dtype="float32")
    s_batch = train_scene(128, 128, 16, seed=13)
    runs = []
    for device in (dev, dev, "cpu"):
        m = MVSNet(s_cfg, seed=3)
        perturb_norms(m, seed=4)
        st = train_lib.create_train_state(m, s_cfg, tcfg, device=device)
        _, met = train_lib.make_train_step(m, s_cfg, tcfg)(st, s_batch)
        runs.append((met["loss"].item(),
                     {n: p.grad.cpu().numpy() for n, p in m.named_parameters()},
                     {n: b.cpu().numpy() for n, b in m.named_buffers()}))
    good, text = step_errors(runs[0], runs[2], vanishing=("gru_sweep.gru.prob_conv.bias",))
    print(f"  R-MVSNet train step 128x128 D=16 normal f32, card vs CPU: {text}")
    repeat, first = repeat_difference(runs[0], runs[1])
    print(f"  two card steps from the same state and batch: largest difference {repeat:.3e}"
          + ("" if first is None else f", first in {first}") + f" (bound 0) "
          f"{'ok' if repeat == 0 else 'FAIL'}")
    return counts if finite and good and repeat == 0 else None


# phases 12-14 and 8e: refinement with the training driver's defaults
# (mvsnet_tpu/train.py:57-65): the U-Net, upsampled to the images, with the
# confidence channel
REFINE_ARGS = dict(refinement=True, refinement_network="unet",
                   upsample_before_refinement=True, refine_with_confidence=True)
# per refined request, derived from the model: the tower's 28 convs and 4
# transposed convs and the 3D U-Net's 8 and 3, then the refinement U-Net's
# 24 and 4; every one on the tensor cores, the two image convs of the tower
# and the two Cin = 5 convs of the refinement net (image, depth,
# confidence) with Cin zero-padded
REFINE_LAUNCHES = {"conv": 36 + 24, "deconv": 7 + 4}
REFINE_EDITIONS = {"conv": {"tc": 60, "simt": 0}, "deconv": {"tc": 11, "simt": 0}}
# card vs CPU, float32: the refined depth within phase 5's depth bound (the
# net adds its residual to the depth) and the residual within this share of
# max(1, max|residual|)
REFINE_RESIDUAL_TOL = 1e-3
# phase 8e: refined serving on the ranks
REFINE_MULTI_CFG_ARGS = dict(view_num=3, max_d=32, width=320, height=256, network_mode="normal",
                             compute_dtype="float32", **REFINE_ARGS)


def refine_train_scene(H, W, D, seed):
    """`train_scene` with the full-resolution depth the refined loss reads
    (the ground truth repeated 4x4, as a nearest-neighbour upsample)."""
    images, cams, gt, _ = train_scene(H, W, D, seed)
    return images, cams, gt, np.repeat(np.repeat(gt, 4, axis=1), 4, axis=2)


def refined_card_vs_cpu(dev, cfg, inputs, seed):
    """A refined `Predictor` with seeded weights on the card and on the CPU:
    (ok, text) under phase 5's bounds and REFINE_RESIDUAL_TOL."""
    from mvsnet_tpu_torch.predict import Predictor

    (d_g, p_g, r_g), (d_c, p_c, r_c) = (Predictor(cfg, seed=seed, device=d).predict(*inputs)
                                        for d in (dev, "cpu"))
    d_err, p_err = float(np.abs(d_g - d_c).max()), float(np.abs(p_g - p_c).max())
    r_tol = REFINE_RESIDUAL_TOL * max(1.0, float(np.abs(r_c).max()))
    r_err = float(np.abs(r_g - r_c).max())
    ok = (all(np.isfinite(o).all() for o in (d_g, p_g, r_g)) and d_err <= E2E_DEPTH_ATOL
          and p_err <= E2E_PROB_ATOL and r_err <= r_tol)
    return ok, (f"refined depth max abs err {d_err:.3e} (bound {E2E_DEPTH_ATOL:g}), prob "
                f"{p_err:.3e} (bound {E2E_PROB_ATOL:g}), residual {r_err:.3e} (bound "
                f"{r_tol:.3e}, max|residual| {float(np.abs(r_c).max()):.3e}) "
                f"{'ok' if ok else 'FAIL'}")


def phase12_refined_serving(smi, dev, request, variant_sizes=((864, 1152), (768, 1024)),
                            small=(256, 320, 32)):
    """Refined serving at the point of `request` (main passes phase 4's:
    1152x864, D=192, V=3), two other variants at `variant_sizes` (height,
    width), and card against CPU at `small` (height, width, D); returns the
    launch counts of its 3 counted requests, or None on failure."""
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.ops.cost_volume import plane_sweep_cost_volume
    from mvsnet_tpu_torch.ops.resize import resize_bilinear
    from mvsnet_tpu_torch.predict import Predictor, depth_params_from_cams

    _, V, H, W, _ = request[0].shape
    D = int(request[1][0, 0, 1, 3, 2])
    cfg = ModelConfig(view_num=V, max_d=D, width=W, height=H, network_mode="normal",
                      compute_dtype="bfloat16", **REFINE_ARGS)
    point = f"{W}x{H}, D={D}, V={V}"
    predictor = Predictor(cfg, seed=0, device=dev)
    model = predictor.model
    want_launches, want_editions = expected_serving(model, torch.bfloat16)
    derived = ({k: want_launches[k] for k in REFINE_LAUNCHES},
               {k: want_editions[k] for k in REFINE_EDITIONS})
    if derived != (REFINE_LAUNCHES, REFINE_EDITIONS):
        print(f"phase 12 FAILED: the model gives {derived}, not {REFINE_LAUNCHES}, "
              f"{REFINE_EDITIONS}")
        return None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor.predict(*request, fetch=False)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_request, editions, finite, depth, prob = serve_counted(predictor, request)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 12: refined serving, Predictor at {point}, normal, bf16, "
          f"refinement U-Net upsampled with confidence (the training driver's defaults): "
          f"first request {first_ms:.2f} ms, then wall ms {', '.join(f'{w:.2f}' for w in walls)}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB; refined depth {tuple(depth.shape)} in "
          f"[{depth.min().item():.1f}, {depth.max().item():.1f}] [{smi}]")
    print(f"  launches per request {per_request[-1]} (expected {want_launches}); editions "
          f"{editions[-1]} (expected {want_editions})")
    if (not finite or tuple(depth.shape) != (1, H, W, 1)
            or any(r != want_launches for r in per_request)
            or any(e != want_editions for e in editions)):
        print(f"phase 12 FAILED: finite {finite}, launches {per_request}, editions {editions}")
        return None

    # one request stage by stage (CUDA events), the refinement's steps
    # written out; it must give the Predictor's refined depth bit for bit
    with torch.inference_mode():
        x, cams_t, ds_t, di_t = (torch.as_tensor(a, device=dev) for a in request[:4])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        ref_f, view_f = model.extract_features(x)
        ev[1].record()
        ds_b, di_b, de_b = model.depth_range(ds_t, di_t, 1, dev)
        cost = plane_sweep_cost_volume(ref_f, view_f, model.homographies(cams_t, ds_b, di_b,
                                                                          de_b))
        ev[2].record()
        reg = model.regnet(cost)[..., 0].to(torch.float32)
        ev[3].record()
        d, p = model.depth_tail(reg, ds_b, di_b, de_b)
        ev[4].record()
        scale = (de_b - ds_b)[:, None, None, None]
        norm, d_up, p_up = (resize_bilinear(t, H, W)
                            for t in ((d - ds_b[:, None, None, None]) / scale, d, p))
        ev[5].record()
        residual = model.refine_net(x[:, 0], torch.cat([norm, p_up], dim=-1)).float() * scale
        ev[6].record()
        torch.cuda.synchronize()
        same = torch.equal(residual + d_up, depth)
    names = ["feature_net", "homographies + cost_volume", "regnet", "depth_tail",
             "upsample (depth, normalised depth, prob)", "refine_net"]
    print("  stages (ms, CUDA events, one request): " + ", ".join(
        f"{n} {ev[i].elapsed_time(ev[i + 1]):.3f}" for i, n in enumerate(names))
        + f"; their refined depth equals the Predictor's bit for bit: {same}")
    print_profile("refined request", *profile_device(
        lambda: predictor.predict(*request, fetch=False)))
    # the refinement's two parts alone, on the staged request's tensors
    with torch.inference_mode():
        up_wall, up_busy, _, _ = profile_device(
            lambda: [resize_bilinear(t, H, W) for t in (norm, d, p)])
        print(f"  profiled alone: the upsample's three resizes wall {up_wall:.3f} ms, device busy "
              + ("not measured" if up_busy is None else f"{up_busy:.3f} ms"))
        print_profile("refinement net alone", *profile_device(
            lambda: model.refine_net(x[:, 0], torch.cat([norm, p_up], dim=-1))))
    del predictor, model, ref_f, view_f, cost, reg, d, p, norm, d_up, p_up, residual, depth
    torch.cuda.empty_cache()
    if not same:
        print("phase 12 FAILED: the staged request differs from the Predictor's")
        return None

    # the other variants, one request each
    ok = True
    for what, kw, (vh, vw) in zip(
            ("the original net with the stereo view (first conv Cin 8: tensor cores)",
             "the U-Net at the cost volume's resolution (upsample_before_refinement=False; "
             "its height and width divide by 16)"),
            (dict(refinement_network="original", refine_with_stereo=True),
             dict(upsample_before_refinement=False)), variant_sizes):
        v_cfg = dataclasses.replace(cfg, width=vw, height=vh, **kw)
        v_images, v_cams = scene(1, V, vh, vw, D, seed=15)
        v_ds, v_di, _, v_de = depth_params_from_cams(v_cams)
        v_in = (v_images, v_cams, v_ds, v_di, v_de)
        p = Predictor(v_cfg, seed=0, device=dev)
        want_l, want_e = expected_serving(p.model, torch.bfloat16)
        p.predict(*v_in, fetch=False)
        v_walls, v_req, v_ed, v_fin, v_depth, _ = serve_counted(p, v_in, n=1)
        side = (vh, vw) if v_cfg.upsample_before_refinement else (vh // 4, vw // 4)
        good = (v_fin and v_req == [want_l] and v_ed == [want_e]
                and tuple(v_depth.shape[1:3]) == side)
        ok = ok and good
        print(f"  {what}, {vw}x{vh}, D={D}, bf16: wall {v_walls[0]:.2f} ms; refined depth "
              f"{tuple(v_depth.shape)}; launches {v_req[0]} (expected {want_l}); conv "
              f"editions {v_ed[0]['conv']} (expected {want_e['conv']}) "
              f"{'ok' if good else 'FAIL'} [{smi}]")
        del p, v_depth
        torch.cuda.empty_cache()

    # card against CPU at `small`, float32
    sh, sw, sd = small
    s_cfg = dataclasses.replace(cfg, max_d=sd, width=sw, height=sh, compute_dtype="float32")
    s_images, s_cams = scene(1, V, sh, sw, sd, seed=16)
    s_ds, s_di, _, s_de = depth_params_from_cams(s_cams)
    good, text = refined_card_vs_cpu(dev, s_cfg, (s_images, s_cams, s_ds, s_di, s_de), seed=1)
    print(f"  refined request {sw}x{sh} D={sd} normal f32, card vs CPU: {text}")
    return counts if ok and good else None


def phase13_refined_training(smi, dev, point=(480, 640, 192), small=(128, 128, 16)):
    """Refined training at the training point (`point`: height, width, D),
    "all" mode, and one float32 step card against CPU at `small`; returns
    the launch counts of its 3 counted steps, or None on failure."""
    from mvsnet_tpu_torch import train_lib
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels

    H, W, D = point
    cfg = ModelConfig(view_num=3, max_d=D, width=W, height=H, network_mode="normal",
                      compute_dtype="bfloat16", **REFINE_ARGS)
    tcfg = TrainConfig()
    t_batch = refine_train_scene(H, W, D, seed=17)
    model = MVSNet(cfg, seed=0)
    want = expected_train_launches(model, cfg, H // 4, W // 4)
    want_ed = expected_train_editions(model, torch.bfloat16)
    state = train_lib.create_train_state(model, cfg, tcfg, device=dev)
    step = train_lib.make_train_step(model, cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_step, per_ed, losses = [], [], [], []
    for _ in range(3):
        before, ed_before = kernels.launch_counts(), kernels.edition_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, t_batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after, ed_after = kernels.launch_counts(), kernels.edition_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        per_ed.append({k: {e: n - ed_before[k][e] for e, n in v.items()}
                       for k, v in ed_after.items()})
        losses.append(metrics["loss"].item())
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(v) for v in losses) and all(
        bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    print(f"phase 13: refined training, 3 steps at {W}x{H}, D={D}, V=3, normal, bf16, rmsprop, "
          f"power + gradient loss, refinement_train_mode all: step ms "
          f"{', '.join(f'{w:.2f}' for w in walls)} (the first includes set-up); peak memory "
          f"{peak / 2 ** 30:.3f} GiB; losses {', '.join(f'{v:.4f}' for v in losses)} [{smi}]")
    print(f"  launches per step {per_step[-1]} (expected {want}); editions {per_ed[-1]} "
          f"(expected {want_ed})")
    idle = [k for k in DRIVER_PATH_KERNELS if counts[k] == 0]
    if (not finite or idle or any(r != want for r in per_step)
            or any(e != want_ed for e in per_ed)):
        print(f"phase 13 FAILED: finite {finite}, kernels never launched {idle}, launches "
              f"{per_step}, editions {per_ed}")
        return None

    batch = train_lib.to_device(t_batch, dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    state.optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    loss, _ = train_lib.compute_loss(model, cfg, tcfg, batch, training=True)
    ev[1].record()
    loss.backward()
    ev[2].record()
    train_lib.apply_gradients(state, tcfg)
    ev[3].record()
    torch.cuda.synchronize()
    print("  stages (ms, CUDA events, one step): " + ", ".join(
        f"{n} {ev[i].elapsed_time(ev[i + 1]):.3f}"
        for i, n in enumerate(["forward", "backward", "optimizer"])))
    print_profile("refined train step", *profile_device(lambda: step(state, t_batch)))
    del state, model, step, batch, loss
    torch.cuda.empty_cache()

    # one float32 step at `small`: card vs CPU, and two card steps
    sh, sw, sd = small
    s_cfg = dataclasses.replace(cfg, max_d=sd, width=sw, height=sh, compute_dtype="float32")
    s_batch = refine_train_scene(sh, sw, sd, seed=18)
    runs = []
    for device in (dev, dev, "cpu"):
        m = MVSNet(s_cfg, seed=3)
        perturb_norms(m, seed=4)
        st = train_lib.create_train_state(m, s_cfg, tcfg, device=device)
        _, met = train_lib.make_train_step(m, s_cfg, tcfg)(st, s_batch)
        runs.append((met["loss"].item(),
                     {n: p.grad.cpu().numpy() for n, p in m.named_parameters()},
                     {n: b.cpu().numpy() for n, b in m.named_buffers()}))
    good, text = step_errors(runs[0], runs[2])
    print(f"  refined train step {sw}x{sh} D={sd} normal f32, card vs CPU: {text}")
    repeat, first = repeat_difference(runs[0], runs[1])
    print(f"  two card steps from the same state and batch: largest difference {repeat:.3e}"
          + ("" if first is None else f", first in {first}") + f" (bound 0) "
          f"{'ok' if repeat == 0 else 'FAIL'}")
    return counts if good and repeat == 0 else None


def write_rendered_session(path, W, H, N, seed):
    """A session of `data/synthetic.py`'s rendered plane scene, N images of
    WxH, on disk as the data plane reads it: `images/<i>.jpg` (the port's
    JPEG encoder), cameras, covisibility and depth PNGs."""
    import os

    from mvsnet_tpu_torch.data.synthetic import render_session
    from mvsnet_tpu_torch.io import images as imio

    session = render_session(W, H, n_images=N, seed=seed)
    for sub in ("images", "cameras", "depths"):
        os.makedirs(os.path.join(path, sub))
    for i, (img, cam, depth) in enumerate(zip(session["images"], session["cameras"],
                                              session["depths"])):
        imio.write_image(os.path.join(path, "images", f"{i}.jpg"), img)
        with open(os.path.join(path, "cameras", f"{i}.json"), "w") as f:
            json.dump(cam, f)
        imio.write_depth_png(os.path.join(path, "depths", f"{i}.png"), depth)
    with open(os.path.join(path, "covisibility.json"), "w") as f:
        json.dump(session["covisibility"], f)


def phase14_drivers(smi, dev, point=(384, 512, 4, 192), clusters=5):
    """The serving drivers `test.main` and `infer.main` with refinement at
    `point` (height, width, views, D; main passes the test driver's),
    `clusters` a session; returns whether every check held."""
    import os
    import tempfile

    from mvsnet_tpu_torch import checkpoint, infer, predict, train_lib
    from mvsnet_tpu_torch import test as bench_driver
    from mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from mvsnet_tpu_torch.io import images as imio
    from mvsnet_tpu_torch.io.cams import load_cam_txt
    from mvsnet_tpu_torch.io.pfm import load_pfm
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.ops import kernels

    (H, W, V, D), N = point, clusters
    print(f"phase 14: the serving drivers (mvsnet_tpu_torch.infer.main, mvsnet_tpu_torch.test."
          f"main) with --refinement at the test driver's point, {W}x{H}, V={V}, D={D}, normal, "
          f"bf16, the refinement U-Net with confidence, on plane scenes rendered by "
          f"data/synthetic.py and written to disk ({N} clusters a session; the images as JPEGs "
          f"by the port's encoder); the drivers read them and write each reference image "
          f"<index>.jpg with the port's codec, and the drivers, Predictor, writers and results "
          f"CSV run as a user runs them [{smi}]")
    ok = True
    with tempfile.TemporaryDirectory(prefix="mvsnet_serving_") as root:
        infer_dir, bench_dir = os.path.join(root, "session"), os.path.join(root, "bench")
        write_rendered_session(infer_dir, W, H, N, 0)
        write_rendered_session(os.path.join(bench_dir, "test", "session_0"), W, H, N, 1)
        model_dir, results = os.path.join(root, "models"), os.path.join(root, "results.csv")
        cfg = ModelConfig(view_num=V, max_d=D, width=W, height=H, network_mode="normal",
                          compute_dtype="bfloat16", **REFINE_ARGS)
        state = train_lib.create_train_state(MVSNet(cfg, seed=0), cfg, TrainConfig(), device=dev)
        checkpoint.save_checkpoint(model_dir, "3DCNN", "normal", 100, state)
        del state
        common = ["--view_num", str(V), "--max_d", str(D), "--width", str(W), "--height", str(H),
                  "--network_mode", "normal", "--compute_dtype", "bfloat16", "--refinement",
                  "--refinement_network", "unet", "--refine_with_confidence", "--visualize",
                  "--model_dir", model_dir, "--ckpt_step", "100", "--device", str(dev)]
        runs = {"infer": (infer.main, ["--input_dir", infer_dir,
                                       "--upsample_before_refinement"]),
                "test": (bench_driver.main, ["--input_dir", bench_dir, "--results_path",
                                             results, "--write_output"])}
        # timed, not replaced: the writer thread's batches and its JPEG writes
        real = predict.write_output, predict.write_image
        writer_ms, jpeg_ms = [], []

        def timed(fn, into):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                fn(*args, **kwargs)
                into.append((time.perf_counter() - t0) * 1e3)
            return run

        predict.write_output = timed(real[0], writer_ms)
        predict.write_image = timed(real[1], jpeg_ms)
        out = {}
        try:
            for name, (main_fn, args) in runs.items():
                kernels.reset_launch_counts()
                del writer_ms[:], jpeg_ms[:]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = main_fn(args + common)
                torch.cuda.synchronize()
                out[name] = (rc, (time.perf_counter() - t0) * 1e3, kernels.launch_counts(),
                             list(writer_ms), list(jpeg_ms))
        finally:
            predict.write_output, predict.write_image = real
        # read every file back: (full resolution with the net upsampled, the
        # cost volume's without; the test driver resizes its depth to the
        # ground truth before writing it)
        h, w = H // 4, W // 4
        shapes = {"infer": {"init": (H, W), "prob": (H, W), "residual": (H, W),
                            "jpg": (H, W, 3)},
                  "test": {"init": (H, W), "prob": (h, w), "residual": (h, w),
                           "jpg": (h, w, 3)}}
        for name, out_dir in (("infer", os.path.join(infer_dir, "depths_mvsnet")),
                              ("test", os.path.join(bench_dir, "test", "session_0",
                                                    "depths_mvsnet"))):
            rc, wall, counts, writes, jpegs = out[name]
            bad, seen = [], 0
            for i in range(N):
                def path(suffix):
                    return os.path.join(out_dir, f"{i}{suffix}")
                maps = {k: load_pfm(path(f"_{k}.pfm")) for k in ("init", "prob", "residual")}
                pngs = {k: imio.read_png(path(f"_{k}.png"))
                        for k in ("depth", "prob", "depth_inverse")}
                ref_image = imio.load_image(path(".jpg"))
                cam = load_cam_txt(path(".txt"))
                seen += 8
                for k, m in maps.items():
                    if m.shape != shapes[name][k] or not np.isfinite(m).all():
                        bad.append(f"{i}_{k}.pfm {m.shape}")
                for k, png in pngs.items():
                    want = shapes[name]["prob" if k == "prob" else "init"]
                    if png.shape != want or png.dtype != np.uint16:
                        bad.append(f"{i}_{k}.png {png.shape} {png.dtype}")
                if ref_image.shape != shapes[name]["jpg"] or not np.isfinite(cam).all():
                    bad.append(f"{i}.jpg {ref_image.shape} / {i}.txt")
                if not np.array_equal(pngs["depth"], np.clip(maps["init"], 0, 65535).astype(
                        np.uint16)):
                    bad.append(f"{i}_depth.png is not its PFM")
            idle = [k for k in ("cost_volume", "conv", "deconv") if counts[k] == 0]
            good = rc == 0 and not bad and not idle and len(os.listdir(out_dir)) == seen
            ok = ok and good
            print(f"  {name}.main: rc {rc}, {wall:.1f} ms for {N} clusters "
                  f"({wall / N:.1f} ms a cluster, the first's set-up and restore included); "
                  f"writer thread {sum(writes):.1f} ms ({np.median(writes):.2f} ms a cluster), of "
                  f"which the reference JPEG writes {sum(jpegs):.1f} ms ({np.median(jpegs):.2f} ms "
                  f"each); read back {len(os.listdir(out_dir))} files (PFMs, PNGs and reference "
                  f"JPEGs by the port's decoders, cams): {'ok' if not bad else bad}; launches "
                  f"{ {k: counts[k] for k in ('cost_volume', 'conv', 'deconv')} } "
                  f"{'ok' if good else 'FAIL'} [{smi}]")
        with open(results) as f:
            lines = f.readlines()
        fields = lines[1].split(", ") if len(lines) == 2 else []
        row_ok = (lines[:1] == [predict.RESULTS_HEADER] and len(fields) == 6
                  and fields[:2] == [model_dir, "100"] and lines[1].endswith(" \n")
                  and all(np.isfinite(float(x)) for x in fields[2:]))
        ok = ok and row_ok
        print(f"  results CSV: {lines!r} {'ok' if row_ok else 'FAIL'}")
    if not ok:
        print("phase 14 FAILED")
    return ok


# phase 15: the analytic scene of tests/test_fusion_quality.py (a sphere cap
# in front of a background plane, depths exact at pixel centres), the
# reference's fusion thresholds (depthfusion.py), and the bounds of the
# card-vs-CPU fusion check
SPHERE_CENTER = np.array([0.0, 0.0, 2000.0])
SPHERE_RADIUS = 400.0
SPHERE_BG = 2400.0
FUSION_ARGS = dict(disp_threshold=0.25, num_consistent=3, depth_rel_threshold=0.01)
# card vs CPU: float32 projections in another order flip a pixel's
# pass/fail only at a threshold's edge, and move a fused point by ulps
FUSION_MASK_TOL = 1e-3            # share of pixels whose keep mask may differ
FUSION_POINT_TOL = 1e-4 * SPHERE_BG


def sphere_scene(H, W, grid, baseline=60.0):
    """Depth maps (H, W) and cam tensors of the sphere scene seen by
    rows x cols cameras translated on a grid `baseline` mm apart, looking
    along +z (`tests/test_fusion_quality.py:_sphere_depth`, in numpy here)."""
    focal = W * 1.2
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])
    us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    d = np.stack([(us - W / 2.0) / focal, (vs - H / 2.0) / focal, np.ones_like(us)], axis=-1)
    a = (d * d).sum(-1)
    rows, cols = grid
    depths, cams = [], []
    for r in range(rows):
        for c in range(cols):
            pos = np.array([baseline * (c - (cols - 1) / 2), baseline * (r - (rows - 1) / 2), 0.0])
            oc = pos - SPHERE_CENTER
            b = 2.0 * (d @ oc)
            disc = b * b - 4 * a * ((oc * oc).sum() - SPHERE_RADIUS ** 2)
            hit = disc > 0
            t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), 0.0)
            depths.append(np.where(hit & (t > 0), t * d[..., 2],
                                   SPHERE_BG - pos[2]).astype(np.float32))
            cam = np.zeros((2, 4, 4))
            cam[0] = np.eye(4)
            cam[0, :3, 3] = -pos                  # world -> camera: x_cam = x - pos
            cam[1, :3, :3] = K
            cam[1, 3] = [1500.0, 1000 / 7, 8, 2500.0]
            cams.append(cam)
    return depths, cams


def sphere_quality(points, dev):
    """`tests/test_fusion_quality.py:79-103`'s gates on a fused cloud:
    (ok, text). Nearest distances of the 800 cap samples on the card, in
    chunks of the cloud."""
    dist_sphere = np.abs(np.linalg.norm(points - SPHERE_CENTER, axis=1) - SPHERE_RADIUS)
    dist_bg = np.abs(points[:, 2] - SPHERE_BG)
    on_sphere = dist_sphere < dist_bg
    acc = dist_sphere[on_sphere]
    rng = np.random.default_rng(0)
    zs = rng.uniform(-SPHERE_RADIUS, -0.6 * SPHERE_RADIUS, 800)
    phis = rng.uniform(0, 2 * np.pi, 800)
    rr = np.sqrt(SPHERE_RADIUS ** 2 - zs ** 2)
    gt = torch.as_tensor(SPHERE_CENTER + np.stack([rr * np.cos(phis), rr * np.sin(phis), zs],
                                                  axis=1), dtype=torch.float32, device=dev)
    sphere = torch.as_tensor(points[on_sphere], device=dev)
    nearest = torch.full((800,), float("inf"), device=dev)
    for c0 in range(0, len(sphere), 1 << 20):
        nearest = torch.minimum(nearest, torch.cdist(gt, sphere[c0:c0 + (1 << 20)]).amin(dim=1))
    completeness = float((nearest < 20.0).float().mean())
    median = float(np.median(acc)) if len(acc) else float("inf")
    p90 = float(np.percentile(acc, 90)) if len(acc) else float("inf")
    bg_share = float(np.mean(dist_bg[~on_sphere] < 10.0)) if (~on_sphere).any() else 0.0
    ok = (on_sphere.sum() > 300 and median < 0.5 and p90 < 2.0 and bg_share > 0.95
          and completeness > 0.9)
    return ok, (f"{len(points)} points, {int(on_sphere.sum())} on the sphere: accuracy median "
                f"{median:.4f} mm (gate 0.5), p90 {p90:.4f} mm (gate 2.0); background within "
                f"10 mm {bg_share:.4f} (gate 0.95); completeness@20mm {completeness:.4f} "
                f"(gate 0.9) {'ok' if ok else 'FAIL'}")


def _sorted_cloud(points, colors=None):
    order = np.lexsort(points.T[::-1])
    return points[order], (None if colors is None else colors[order])


def phase15_import(smi, dev, request, gru_point=(256, 320, 32)):
    """15a: Saver V2 bundles in the reference's naming from seeded models
    (3D-CNN `normal` with the refinement U-Net, and the GRU), imported into
    model dirs; the restored weights and `Predictor(mcfg, model_dir,
    ckpt_step)`'s answers equal the seeded model's bit for bit, the 3D-CNN
    at `request`'s point, the GRU at `gru_point` (height, width, D). 15d's
    trace of one `Predictor` call. Returns (ok, the 3D-CNN's model dir,
    step, its checkpoint root)."""
    import os
    import tempfile

    from mvsnet_tpu_torch import checkpoint, tf_import
    from mvsnet_tpu_torch.config import ModelConfig
    from mvsnet_tpu_torch.io import tf_bundle
    from mvsnet_tpu_torch.models import MVSNet
    from mvsnet_tpu_torch.predict import Predictor, depth_params_from_cams
    from mvsnet_tpu_torch.utils import profiling

    images = request[0]
    H, W, D = images.shape[2], images.shape[3], int(request[1][0, 0, 1, 3, 2])
    gh, gw, gd = gru_point
    g_images, g_cams = scene(1, 3, gh, gw, gd, seed=15)
    gds, gdi, _, gde = depth_params_from_cams(g_cams)
    points = {"3DCNN": (ModelConfig(view_num=3, max_d=D, width=W, height=H, network_mode="normal",
                                    compute_dtype="bfloat16", **REFINE_ARGS), REFINE_ARGS,
                        request),
              "GRU": (ModelConfig(view_num=3, max_d=gd, width=gw, height=gh, network_mode="normal",
                                  regularization="GRU", compute_dtype="bfloat16"), {},
                      (g_images, g_cams, gds, gdi, gde))}
    print(f"phase 15a: TF-checkpoint import (mvsnet_tpu_torch.tf_import): Saver V2 bundles in "
          f"the reference's TF names and layouts (transposed-conv kernels (..., out, in), the "
          f"GRU norms as LayerNorm) written by io/tf_bundle.write_bundle from seeded models "
          f"with perturbed norms, imported with import_checkpoint, served by Predictor(mcfg, "
          f"model_dir, ckpt_step) against a Predictor of the seeded state dict: 3D-CNN normal "
          f"with the refinement U-Net at {W}x{H}, D={D}; GRU normal at {gw}x{gh}, D={gd}; "
          f"bf16 [{smi}]")
    root = tempfile.mkdtemp(prefix="mvsnet_import_")
    ok, step = True, 150000
    for reg, (cfg, options, inputs) in points.items():
        model = MVSNet(cfg, seed=20)
        perturb_norms(model, 21)
        seeded = model.state_dict()
        prefix = os.path.join(root, reg, f"tf_model_{step}.ckpt")
        t0 = time.perf_counter()
        tf_vars = tf_import.export_tf_vars(model)
        tf_bundle.write_bundle(prefix, tf_vars)
        write_ms = (time.perf_counter() - t0) * 1e3
        size = sum(os.path.getsize(os.path.join(root, reg, f)) for f in os.listdir(
            os.path.join(root, reg)))
        t0 = time.perf_counter()
        var_dict = tf_import.load_tf_checkpoint(prefix)
        read_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mapped = tf_import.import_tf_vars(var_dict, MVSNet(cfg))
        map_ms = (time.perf_counter() - t0) * 1e3
        model_dir = os.path.join(root, "models")
        t0 = time.perf_counter()
        out = tf_import.import_checkpoint(prefix, model_dir, reg, "normal", **options)
        import_ms = (time.perf_counter() - t0) * 1e3
        restored = checkpoint.restore_tree(model_dir, reg, "normal", step)["model"]
        same = (sorted(restored) == sorted(seeded) == sorted(mapped)
                and all(torch.equal(restored[k], seeded[k]) and torch.equal(mapped[k], seeded[k])
                        for k in seeded))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = Predictor(cfg, model_dir, step, device=dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        got = served.predict(*inputs)
        want = Predictor(cfg, state_dict=seeded, device=dev).predict(*inputs)
        equal = all(np.array_equal(a, b) for a, b in zip(got, want))
        finite = all(np.isfinite(a).all() for a in got)
        good = same and equal and finite and out == os.path.join(model_dir, reg, "normal",
                                                                 str(step))
        ok = ok and good
        print(f"  {reg}: {len(tf_vars)} TF variables, bundle {size} bytes (write {write_ms:.1f} "
              f"ms); bundle read {read_ms:.1f} ms, mapping {map_ms:.1f} ms, import_checkpoint "
              f"(read, map, save) {import_ms:.1f} ms, restore into a Predictor on the card "
              f"{restore_ms:.1f} ms; restored == seeded bit for bit: {same}; depth, prob, "
              f"residual == the seeded Predictor's bit for bit: {equal} "
              f"{'ok' if good else 'FAIL'} [{smi}]")
        if reg == "3DCNN":
            trace_dir = os.path.join(root, "trace")
            with profiling.trace(trace_dir):
                served.predict(*inputs)
            traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
            stats = profiling.device_memory_stats()
            good = (len(traces) == 1 and os.path.getsize(os.path.join(trace_dir, traces[0])) > 0
                    and stats is not None and stats.get("allocated_bytes.all.current", 0) > 0)
            ok = ok and good
            print(f"  15d: utils.profiling.trace around one Predictor call wrote {traces} "
                  f"({sum(os.path.getsize(os.path.join(trace_dir, f)) for f in traces)} bytes); "
                  f"device_memory_stats(): {len(stats or {})} counters, allocated "
                  f"{(stats or {}).get('allocated_bytes.all.current', 0) / 2 ** 20:.1f} MiB "
                  f"{'ok' if good else 'FAIL'}")
        del model, served, mapped, restored
        torch.cuda.empty_cache()
    return ok, model_dir, step, root


def phase15_chain(smi, dev, model_dir, step, point=(384, 512, 4, 192), clusters=5):
    """15b and 15d: `infer.main` with refinement from the imported model dir
    at `point` (height, width, views, D), then `fusion.main` on the card:
    default thresholds, shards merged, the native consolidation, the gipuma
    export; every file read back, `visualize.load_depth_any` included.
    Returns whether every check held."""
    import os
    import tempfile

    from mvsnet_tpu_torch import fusion, infer, visualize
    from mvsnet_tpu_torch.io.cams import load_cam_txt, projection_matrix
    from mvsnet_tpu_torch.io.dmb import read_dmb
    from mvsnet_tpu_torch.io.pfm import load_pfm
    from mvsnet_tpu_torch.io.ply import read_ply
    from mvsnet_tpu_torch.ops import kernels

    (H, W, V, D), N = point, clusters
    print(f"phase 15b: the user's chain from the imported checkpoint: infer.main --model_dir "
          f"<imported> --ckpt_step {step} --refinement (the U-Net, upsampled, with confidence) "
          f"at {W}x{H}, V={V}, D={D}, normal, bf16, {N} clusters of a rendered session, then "
          f"fusion.main --dense_folder on the card (default device): the reference's "
          f"thresholds, 2 shards + merge-shards, --voxel_size/--min_neighbors, gipuma-export; "
          f"every JPEG (the session's, each <index>.jpg and fusion's read of it) through the "
          f"port's codec. Seeded weights: the gates are on well-formed output, not on the "
          f"point count [{smi}]")
    ok = True
    with tempfile.TemporaryDirectory(prefix="mvsnet_chain_") as root:
        session = os.path.join(root, "session")
        write_rendered_session(session, W, H, N, 2)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = infer.main(["--input_dir", session, "--view_num", str(V), "--max_d", str(D),
                         "--width", str(W), "--height", str(H), "--network_mode", "normal",
                         "--compute_dtype", "bfloat16", "--refinement",
                         "--refinement_network", "unet", "--refine_with_confidence",
                         "--upsample_before_refinement", "--visualize", "--model_dir",
                         model_dir, "--ckpt_step", str(step), "--device", str(dev)])
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        idle = [k for k in ("cost_volume", "conv", "deconv") if counts[k] == 0]
        good = rc == 0 and not idle
        ok = ok and good
        print(f"  infer.main: rc {rc}, {infer_ms:.1f} ms for {N} clusters; launches "
              f"{ {k: counts[k] for k in ('cost_volume', 'conv', 'deconv')} } "
              f"{'ok' if good else 'FAIL'}")
        depth_dir = os.path.join(session, "depths_mvsnet")
        ply_path = os.path.join(session, "points_mvsnet", "consistencyCheck",
                                "final3d_model.ply")

        def fuse(*extra):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = fusion.main(["--dense_folder", session, *extra])
            torch.cuda.synchronize()
            return rc, (time.perf_counter() - t0) * 1e3

        def cloud_ok(points, colors):
            return (points.ndim == 2 and points.shape[1] == 3 and np.isfinite(points).all()
                    and colors is not None and colors.shape == points.shape)

        rc, ms = fuse()
        whole = read_ply(ply_path)
        good = rc == 0 and cloud_ok(*whole)
        rcs = [fuse("--shard_count", "2", "--shard_index", str(k))[0] for k in (0, 1)]
        rcs.append(fuse("--mode", "merge-shards")[0])
        merged = read_ply(ply_path)
        a, b = _sorted_cloud(*whole), _sorted_cloud(*merged)
        same = (rcs == [0, 0, 0] and np.array_equal(a[0], b[0])
                and np.array_equal(a[1], b[1]))
        ok = ok and good and same
        print(f"  fusion.main (defaults: prob 0.8, disp 0.25, num_consistent 3, rel 0.01): "
              f"rc {rc}, {ms:.1f} ms, {len(whole[0])} points, the PLY read back "
              f"{'ok' if good else 'FAIL'}; --shard_count 2 then --mode merge-shards: rcs "
              f"{rcs}, the same {len(merged[0])} points and colours as unsharded "
              f"{'ok' if same else 'FAIL'}")
        rc, ms = fuse("--prob_threshold", "0", "--num_consistent", "1", "--voxel_size",
                      "4.0", "--min_neighbors", "2")
        merged_cloud = read_ply(ply_path)
        good = rc == 0 and cloud_ok(*merged_cloud)
        ok = ok and good
        print(f"  fusion.main --prob_threshold 0 --num_consistent 1 --voxel_size 4.0 "
              f"--min_neighbors 2 (the native consolidation on every consistent pixel): rc "
              f"{rc}, {ms:.1f} ms, {len(merged_cloud[0])} points, read back "
              f"{'ok' if good else 'FAIL'}")
        rc, ms = fuse("--mode", "gipuma-export")
        point_dir = os.path.join(session, "points_mvsnet")
        bad = []
        for i in range(N):
            cam = load_cam_txt(os.path.join(depth_dir, f"{i}.txt"))
            with open(os.path.join(point_dir, "cams", f"{i}.jpg.P")) as f:
                P = np.array([[float(x) for x in line.split()] for line in f
                              if line.strip()])
            depth = load_pfm(os.path.join(depth_dir, f"{i}_prob_filtered.pfm"))
            disp = read_dmb(os.path.join(point_dir, f"2333__{i}", "disp.dmb"))
            normals = read_dmb(os.path.join(point_dir, f"2333__{i}", "normals.dmb"))
            if not np.allclose(P, projection_matrix(cam), rtol=1e-12, atol=0):
                bad.append(f"{i}.jpg.P")
            if not np.array_equal(disp, depth) or normals.shape != depth.shape + (3,):
                bad.append(f"2333__{i}")
            if not os.path.isfile(os.path.join(point_dir, "images", f"{i}.jpg")):
                bad.append(f"images/{i}.jpg")
        good = rc == 0 and not bad
        ok = ok and good
        print(f"  fusion.main --mode gipuma-export: rc {rc}, {ms:.1f} ms; {N} .P files, "
              f"disp.dmb (== the filtered depth) and normals.dmb read back: "
              f"{'ok' if not bad else bad}")
        # 15d: the depth-map viewer's reader on the files of phase 14's writers
        shapes = {f: visualize.load_depth_any(os.path.join(depth_dir, f)).shape
                  for f in ("0_init.pfm", "0_depth.png", "0_prob.pfm")}
        shapes["2333__0/disp.dmb"] = visualize.load_depth_any(
            os.path.join(point_dir, "2333__0", "disp.dmb")).shape
        good = all(tuple(x for x in s if x != 1) == (H, W) for s in shapes.values())
        ok = ok and good
        print(f"  15d: visualize.load_depth_any read {shapes} {'ok' if good else 'FAIL'}")
    return ok


def phase15_fusion(smi, dev, full=(864, 1152), grid=(7, 7), small=(256, 320),
                   small_grid=(2, 4)):
    """15c: `fusion.fuse_reference` over every reference view of the sphere
    scene, `grid` cameras at `full` (height, width) on the card, gated by
    the quality test's accuracy and completeness, timed and profiled; the
    same scene at `small` with `small_grid` cameras on the card and on the
    CPU; the native consolidation against its numpy plain versions on the
    small cloud. Returns whether every check held, and the full cloud."""
    from mvsnet_tpu_torch import fusion, native

    (H, W), n = full, grid[0] * grid[1]
    print(f"phase 15c: fusion (mvsnet_tpu_torch.fusion, PyTorch ops on the card) of the "
          f"analytic sphere-cap scene of tests/test_fusion_quality.py seen by {n} translated "
          f"cameras ({grid[0]}x{grid[1]} grid, 60 mm apart) at {W}x{H}, prob 1, the reference's "
          f"thresholds {FUSION_ARGS} [{smi}]")
    t0 = time.perf_counter()
    depths, cams = sphere_scene(H, W, grid)
    scene_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    views = fusion.prepare_views(depths, cams, dev)
    clouds = [fusion.fuse_reference(views, i, **FUSION_ARGS)[1] for i in range(n)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    points = np.concatenate(clouds)
    pairs = n * (n - 1)
    # a pair reads the reference's points (12 B a pixel) and the source's
    # depth (4 B) and gathered points (12 B); it writes its mask (1 B) and
    # hits (12 B)
    pair_bytes = H * W * (12 + 4 + 12 + 1 + 12)
    bound_ms = pair_bytes / HBM_BYTES_PER_S * 1e3
    quality_ok, text = sphere_quality(points, dev)
    print(f"  scene built in {scene_s:.1f} s (numpy); fused {n} reference views in "
          f"{wall_ms:.1f} ms wall ({wall_ms / n:.3f} ms a reference view, {wall_ms / pairs:.4f} "
          f"ms a pair over {pairs} pairs; the views' upload and world points, the masks' and "
          f"points' copies to the host included); bound {bound_ms:.4f} ms a pair "
          f"({pair_bytes / 1e6:.1f} MB at 3.35 TB/s, bytes), {bound_ms * pairs:.2f} ms the "
          f"scene; peak {peak:.3f} GiB [{smi}]")
    print(f"  quality (tests/test_fusion_quality.py's gates): {text}")
    print_profile(f"one reference view ({n - 1} pairs, view {n // 2})", *profile_device(
        lambda: fusion.fuse_reference(views, n // 2, **FUSION_ARGS)))
    t0 = time.perf_counter()
    merged, _ = native.voxel_downsample(points, None, 2.0)
    merge_ms = (time.perf_counter() - t0) * 1e3
    print(f"  the native voxel merge (2 mm) of the {len(points)} points: {len(merged)} points "
          f"in {merge_ms:.1f} ms (host C++, OpenMP build)")
    del views, clouds, merged
    torch.cuda.empty_cache()

    (h, w), m = small, small_grid[0] * small_grid[1]
    depths, cams = sphere_scene(h, w, small_grid)
    runs = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        views = fusion.prepare_views(depths, cams, d)
        out = []
        for i in range(m):
            count, accum = fusion.consistency(views, i, FUSION_ARGS["disp_threshold"],
                                              FUSION_ARGS["depth_rel_threshold"])
            keep = views[i]["valid"] & (count >= FUSION_ARGS["num_consistent"])
            out.append((keep.cpu().numpy(), count.cpu().numpy(),
                        (accum / (count[..., None] + 1.0)).cpu().numpy()))
        runs[label] = out
    mask_diff = sum(int((g[0] != c[0]).sum()) for g, c in zip(runs["card"], runs["cpu"]))
    share = mask_diff / (m * h * w)
    point_err = max(float(np.abs(g[2] - c[2])[g[0] & c[0] & (g[1] == c[1])].max(initial=0))
                    for g, c in zip(runs["card"], runs["cpu"]))
    kept = sum(int(c[0].sum()) for c in runs["cpu"])
    good = share <= FUSION_MASK_TOL and point_err <= FUSION_POINT_TOL and kept > 0
    print(f"  card vs CPU, {m} views ({small_grid[0]}x{small_grid[1]}) at {w}x{h}: keep masks "
          f"differ at {mask_diff} of {m * h * w} pixels ({share:.2e}, bound {FUSION_MASK_TOL:g}; "
          f"{kept} kept on the CPU); fused points where both keep a pixel with the same count: "
          f"max abs err {point_err:.3e} mm (bound {FUSION_POINT_TOL:g}) {'ok' if good else 'FAIL'}")
    cloud = np.concatenate([c[2][c[0]] for c in runs["cpu"]]).astype(np.float32)
    t0 = time.perf_counter()
    got_v = _sorted_cloud(*native.voxel_downsample(cloud, None, 4.0))[0]
    got_m = native.radius_outlier_removal(cloud, 12.0, 4)
    native_ms = (time.perf_counter() - t0) * 1e3
    want_v = _sorted_cloud(*native.voxel_downsample_plain(cloud, None, 4.0))[0]
    want_m = native.radius_outlier_removal_plain(cloud, 12.0, 4)
    native_ok = np.array_equal(got_v, want_v) and np.array_equal(got_m, want_m)
    print(f"  native consolidation (built from mvsnet_tpu_torch/native/pointcloud.cpp by "
          f"{native.compiler()} into {native.build().name}) on the CPU's {len(cloud)} fused "
          f"points: voxel merge (4 mm) -> {len(got_v)} points, outlier mask (radius 12 mm, 4 "
          f"neighbours) keeps {int(got_m.sum())}, {native_ms:.1f} ms; equal to the numpy plain "
          f"versions after sorting: {native_ok} {'ok' if native_ok else 'FAIL'}")
    return quality_ok and good and native_ok, points


def phase15(smi, dev, request):
    """Phase 15: import (a, with d's trace), the chain (b, d), fusion (c).
    Returns 15c's fused cloud, or None on failure."""
    ok, model_dir, step, root = phase15_import(smi, dev, request)
    try:
        ok = phase15_chain(smi, dev, model_dir, step) and ok
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    fused, cloud = phase15_fusion(smi, dev)
    if not (ok and fused):
        print("phase 15 FAILED")
        return None
    return cloud


# phase 16: the DTU chain's inference point, and the ground truth of 15c's
# cloud: points spread evenly over the cap of the sphere that 15c's
# completeness gate samples (z from -R to -0.6 R about the centre)
DTU_INFER_ARGS = ["--view_num", "3", "--max_d", "192", "--width", "640", "--height", "512",
                  "--network_mode", "normal", "--compute_dtype", "bfloat16"]
SPHERE_GT_POINTS = 2_000_000


def sphere_cap_samples(n):
    """n points on the cap on a golden-angle spiral: even in area, since a
    sphere's zones of equal height have equal areas."""
    i = np.arange(n) + 0.5
    z = -SPHERE_RADIUS + 0.4 * SPHERE_RADIUS * i / n
    phi = i * np.pi * (3.0 - np.sqrt(5.0))
    r = np.sqrt(SPHERE_RADIUS ** 2 - z ** 2)
    return SPHERE_CENTER + np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def host_cpu() -> str:
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return f"{line.split(':', 1)[1].strip()}, {os.cpu_count()} cores"
    except OSError:
        pass
    return f"{platform.processor() or platform.machine()}, {os.cpu_count()} cores"


def phase16_chain(smi, dev, root):
    """16a and 16b; returns (ok, the collected PLY's path or None)."""
    from mvsnet_tpu_torch.data.synthetic import write_dtu_scan
    from mvsnet_tpu_torch.io import images as imio
    from mvsnet_tpu_torch.io.cams import load_cam_txt
    from mvsnet_tpu_torch.io.pfm import load_pfm
    from mvsnet_tpu_torch.io.ply import read_ply
    from mvsnet_tpu_torch.ops import kernels
    from mvsnet_tpu_torch.scripts import test_and_fuse
    from mvsnet_tpu_torch.tools import convert_dtu, dtu_fixer, split_data

    views, lightings = 49, 7
    print(f"phase 16a: a DTU-layout scan ({views} views, {lightings} lightings, 640x512 RGB "
          f"PNGs, 160x128 depth PFMs) rendered by data.synthetic.write_dtu_scan, then "
          f"python -m mvsnet_tpu_torch.tools.convert_dtu, .dtu_fixer and .split_data as a user "
          f"runs them; no image codec is installed here [{smi}; host {host_cpu()}]")
    dtu, data = os.path.join(root, "dtu"), os.path.join(root, "sessions")
    times = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    timed("scan", write_dtu_scan, dtu)
    rcs = [timed("convert", convert_dtu.main, [dtu, data]),
           timed("fix", dtu_fixer.main, [data]),
           timed("split", split_data.main, [data])]
    test_root = os.path.join(data, "test")
    sessions = sorted(os.listdir(test_root))
    print(f"  scan written in {times['scan']:.1f} ms (threads); convert_dtu {times['convert']:.1f} "
          f"ms ({times['convert'] / (views * lightings):.2f} ms a view: PNG decode, JPEG encode, "
          f"depth PFM -> PNG, cam -> JSON); dtu_fixer {times['fix']:.1f} ms "
          f"({times['fix'] / lightings:.1f} ms a session of {views} depth maps and cameras); "
          f"split_data {times['split']:.1f} ms; rcs {rcs}; test split {sessions} (host times)")
    ok = rcs == [0, 0, 0] and len(sessions) == 1
    if not ok:
        print("phase 16a FAILED")
        return False, None
    session = os.path.join(test_root, sessions[0])
    bad = []
    for i in range(views):
        img = imio.load_image(os.path.join(session, "images", f"{i}.jpg"))
        depth = imio.read_png(os.path.join(session, "depths", f"{i}.png"))
        with open(os.path.join(session, "cameras", f"{i}.json")) as f:
            cam = json.load(f)
        if img.shape != (512, 640, 3) or depth.shape != (512, 640) or depth.dtype != np.uint16:
            bad.append(f"{i}: {img.shape} {depth.shape} {depth.dtype}")
        if not np.isfinite([cam["intrinsics"][k] for k in ("fx", "fy", "px", "py")]).all():
            bad.append(f"{i}.json")
    with open(os.path.join(session, "covisibility.json")) as f:
        covis = json.load(f)
    if sorted(covis, key=int) != [str(i) for i in range(views)]:
        bad.append("covisibility.json")
    ok = not bad
    print(f"  the test session's {views} JPEGs (the port's decoder), depth PNGs, cameras and "
          f"covisibility read back: {'ok' if ok else bad}")

    plys, results = os.path.join(root, "plys"), os.path.join(root, "fusion_results.csv")
    args = ["--test_folder_root", test_root, "--device", str(dev), "--prob_threshold", "0",
            "--num_consistent", "1", "--ply_folder", plys, "--results_path", results,
            "--infer_args", *DTU_INFER_ARGS]
    print(f"phase 16b: python -m mvsnet_tpu_torch.scripts.test_and_fuse {' '.join(args)} "
          f"(seeded weights: prob stays under the 0.8 default) [{smi}]")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = test_and_fuse.main(args)
    torch.cuda.synchronize()
    taf_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    idle = [k for k in ("cost_volume", "conv", "deconv") if counts[k] == 0]
    runs = os.listdir(plys) if os.path.isdir(plys) else []
    collected = (os.listdir(os.path.join(plys, runs[0])) if len(runs) == 1 else [])
    ply = os.path.join(plys, runs[0], collected[0]) if len(collected) == 1 else None
    points = read_ply(ply)[0] if ply else np.zeros((0, 3))
    with open(results) as f:
        rows = f.readlines()
    rows_ok = rows == ["None, None, [], 0.0, 0.25, 1 \n", "None, None, [[]], 0.0, 0.25, 1 \n"]
    out_dir = os.path.join(session, "depths_mvsnet")
    ref = imio.load_image(os.path.join(out_dir, "0.jpg"))
    h, w = (int(DTU_INFER_ARGS[DTU_INFER_ARGS.index(k) + 1]) // 4 for k in ("--height", "--width"))
    maps_ok = (load_pfm(os.path.join(out_dir, "0_init.pfm")).shape == (h, w)
               and ref.shape == (h, w, 3)
               and np.isfinite(load_cam_txt(os.path.join(out_dir, "0.txt"))).all())
    good = (rc == 0 and not idle and len(points) > 0 and np.isfinite(points).all() and rows_ok
            and maps_ok)
    print(f"  rc {rc}, {taf_ms:.1f} ms for the session ({views} clusters of inference, "
          f"{views}-view fusion, PLY collection; set-up included); launches "
          f"{ {k: counts[k] for k in ('cost_volume', 'conv', 'deconv')} }; collected "
          f"{collected} with {len(points)} points; results CSV {rows!r}; 0_init.pfm, 0.jpg (the "
          f"port's decoder) and 0.txt read back: {maps_ok} {'ok' if good else 'FAIL'}")
    return ok and good, ply


def phase16_scores(smi, root, cloud, dtu_ply):
    """16c: `tools.eval_pointcloud` on 15c's cloud against the sphere cap,
    gated by 15c's own thresholds, and on 16b's PLY; returns whether every
    check held."""
    import contextlib
    import io

    from mvsnet_tpu_torch.io.ply import write_ply
    from mvsnet_tpu_torch.tools import eval_pointcloud

    pred, gt = os.path.join(root, "fused_15c.ply"), os.path.join(root, "sphere_cap.ply")
    t0 = time.perf_counter()
    write_ply(pred, cloud)
    write_ply(gt, sphere_cap_samples(SPHERE_GT_POINTS))
    write_ms = (time.perf_counter() - t0) * 1e3

    def score(args):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = eval_pointcloud.main(args)
        ms = (time.perf_counter() - t0) * 1e3
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), ms

    args = ["--pred", pred, "--gt", gt, "--threshold", "20", "--bbox_margin", "2"]
    rc, m, ms = score(args)
    good = (rc == 0 and m["accuracy_median"] < 0.5 and m["accuracy_p90"] < 2.0
            and m["recall"] > 0.9)
    print(f"phase 16c: python -m mvsnet_tpu_torch.tools.eval_pointcloud {' '.join(args)} on "
          f"15c's {len(cloud)} fused points (subsampled to its default 2M) against "
          f"{SPHERE_GT_POINTS} points spread over the sphere cap (PLYs written in "
          f"{write_ms:.1f} ms): rc {rc}, {ms:.1f} ms (host, scipy cKDTree); accuracy median "
          f"{m.get('accuracy_median', float('nan')):.4f} mm (gate 0.5), p90 "
          f"{m.get('accuracy_p90', float('nan')):.4f} mm (gate 2.0), completeness@20mm "
          f"(recall) {m.get('recall', float('nan')):.4f} (gate 0.9); {m} "
          f"{'ok' if good else 'FAIL'} [host {host_cpu()}]")
    plane = os.path.join(root, "plane.ply")
    xs = np.arange(-300.0, 300.0, 2.0)
    grid = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    write_ply(plane, np.concatenate([grid, np.full((len(grid), 1), 700.0)], axis=1))
    line_ok = False
    if dtu_ply:
        rc2, m2, ms2 = score(["--pred", dtu_ply, "--gt", plane])
        line_ok = "pred_points" in m2 and "gt_points" in m2
        print(f"  on 16b's PLY against the rendered plane (seeded weights: no gate on the "
              f"numbers): rc {rc2}, {ms2:.1f} ms, {m2} {'ok' if line_ok else 'FAIL'}")
    return good and line_ok


def _forward_filter(rows, bpp, kind):
    """PNG filter `kind` (0-4) applied to every row of (H, stride) uint8
    scanlines, as the PNG specification (section 9) defines it: (H,
    stride + 1) raw rows with their filter bytes."""
    rows = rows.astype(np.int64)
    out = []
    for y in range(rows.shape[0]):
        cur, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[y])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][kind]
        out.append(np.concatenate([[kind], (cur - pred) % 256]))
    return np.asarray(out, np.uint8)


def photo(h, w, seed, gray=False):
    """A smooth image with noise, made with numpy alone."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 1 if gray else 3))
    img = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:h, :w]
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def phase16_codec(smi):
    """16d: the native codec against its plain version, and its times;
    returns whether every check held."""
    from mvsnet_tpu_torch import native
    from mvsnet_tpu_torch.io import images as imio
    from mvsnet_tpu_torch.io import jpeg
    from mvsnet_tpu_torch.native import codec

    cases, bad = 0, []
    for h, w in ((8, 8), (37, 53), (64, 48)):
        for sampling in ("4:4:4", "4:2:2", "4:2:0", "gray"):
            img = photo(h, w, seed=h + w, gray=sampling == "gray")
            for quality in (75, 95):
                name = "4:2:0" if sampling == "gray" else sampling
                data = jpeg.encode(img, quality, name)
                cases += 1
                if codec.encode_jpeg(img, quality, name) != data:
                    bad.append(f"encode {h}x{w} {sampling} q{quality}")
                if not np.array_equal(codec.decode_jpeg(data), jpeg.decode(data)):
                    bad.append(f"decode {h}x{w} {sampling} q{quality}")
    rng = np.random.default_rng(16)
    for bpp in (1, 2, 3, 4, 6, 8):
        rows = rng.integers(0, 256, (9, 11 * bpp)).astype(np.uint8)
        rows[3:6] = np.arange(11 * bpp, dtype=np.uint8)            # smooth rows too
        for kind in range(5):
            raw = _forward_filter(rows, bpp, kind).reshape(-1)
            cases += 1
            got = codec.png_unfilter(raw, 9, 11 * bpp, bpp)
            if not (np.array_equal(got, rows)
                    and np.array_equal(imio._unfilter(raw, 9, 11 * bpp, bpp), rows)):
                bad.append(f"unfilter bpp {bpp} filter {kind}")
    ok = not bad
    print(f"phase 16d: the native codec (built from mvsnet_tpu_torch/native/jpeg.cpp by "
          f"{native.compiler('jpeg')} into {native.build('jpeg').name}) against its plain "
          f"version (io/jpeg.py, io/images._unfilter): {cases} cases (JPEG encode and decode at "
          f"8x8, 37x53 and 64x48 in 4:4:4, 4:2:2, 4:2:0 and grayscale, qualities 75 and 95; "
          f"PNG rows forward-filtered with each of the five filter types at 1-8 bytes a pixel) "
          f"bit for bit: {'ok' if ok else bad}")
    for h, w in ((512, 640), (864, 1152), (1200, 1600)):
        img = photo(h, w, seed=w)
        enc, dec = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            data = codec.encode_jpeg(img)
            enc.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            codec.decode_jpeg(data)
            dec.append((time.perf_counter() - t0) * 1e3)
        print(f"  native JPEG at {w}x{h} (quality 75, 4:2:0, {len(data)} bytes): encode "
              f"{np.median(enc):.2f} ms, decode {np.median(dec):.2f} ms "
              f"({h * w / np.median(dec) / 1e3:.1f} Mpixel/s) median of 5, one thread "
              f"[host {host_cpu()}]")
    return ok


def phase16(smi, dev, cloud):
    """Phase 16: the DTU chain (a, b), the scorer (c), the codec (d)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="mvsnet_dtu_") as root:
        ok, ply = phase16_chain(smi, dev, root)
        ok = phase16_scores(smi, root, cloud, ply) and ok
    ok = phase16_codec(smi) and ok
    if not ok:
        print("phase 16 FAILED")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 3 next]", flush=True)
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
    # R-MVSNet's serving point: 1600x1184 images, features 296x400, D=256
    g_images, g_cams = scene(1, 3, 1184, 1600, 256, seed=10)
    g_homs = homs_of(g_cams, 256)
    # the training point: 640x480 images, features 160x120, D=192
    t_batch = train_scene(480, 640, 192, seed=2)
    t_homs = homs_of(t_batch[1], 192)
    if sys.argv[1:] == ["--multi"]:
        k1s = phase8(smi, dev, randn, homs, request)
        if k1s is None:
            return 1
        print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 8i next]",
              flush=True)
        if torch.cuda.device_count() < 4:
            print(f"phase 8i: skipped, it runs the drivers on four cards and this machine has "
                  f"{torch.cuda.device_count()}")
        elif not phase8i_drivers(smi):
            return 1
        return report([k1s[0]])
    cases = []     # one dict per kernel and shape
    peaks = {}     # phase 4's and phase 6's peak memory, for phase 8

    def add_cost(name="cost_volume", hm=homs, h=216, w=288, path=None, C=32):
        D = hm.shape[1]

        def make(dtype):
            return (randn((h, w, C), dtype), randn((2, h, w, C), dtype), hm)
        n_out = D * h * w * C
        ops = n_out * (12 * 2 + 4) + D * h * w * 2 * 25
        cases.append(dict(
            name=name, counter="cost_volume", kernel=sweep.cost_volume,
            plain=sweep.cost_volume_plain, library=None, make=make, path=path,
            bytes=lambda it: (3 * h * w * C + n_out) * it + hm.numel() * 4,
            ops=ops, source="mvsnet_tpu_torch/csrc/cost_volume.cu",
            replaces="mvsnet_tpu/ops/pallas/sweep.py:1094"))

    def add_conv(layer, shape, k, stride, cout, epilogue, replaces, relu=None, path=None):
        """`epilogue`: a bias, and a ReLU unless `relu` says otherwise."""
        cin = shape[-1]
        rank = len(shape) - 2
        relu = epilogue if relu is None else relu

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
            name=f"conv:{layer}", counter="conv", path=path,
            edition=lambda dtype: conv.pick_edition(dtype, cin, cout),
            kernel=lambda x, w, b, edition=None: conv.conv(x, w, b, stride, relu,
                                                           edition=edition),
            plain=lambda x, w, b: conv.conv_plain(x, w, b, stride, relu),
            library=library, library_inputs=library_inputs, make=make,
            bytes=lambda it: (int(np.prod(shape)) + k ** rank * cin * cout + n_out) * it,
            ops=2 * cin * cout * int(taps) * shape[0],
            source="mvsnet_tpu_torch/csrc/conv.cu", replaces=replaces))

    def add_deconv(layer, shape, cout, epilogue, replaces, k=3, out_spatial=None, path=None):
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
            name=f"deconv:{layer}", counter="deconv", path=path,
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

    def add_warp(hm, replaces, C=32, path=None, rows=None):
        """K2 and K3 on the training point's maps (120x160); with `rows`
        (row_offset, Hr) their row-block editions, as the blocked train
        step launches them (counters warp_sharded, warp_transpose_sharded)."""
        D, (H, W) = hm.shape[0], (120, 160)
        tag = "" if path is None else f":{path}"
        r0, Hr = rows or (0, H)
        block = () if rows is None else (r0, Hr)
        t_block = () if rows is None else (r0, H)
        # F.grid_sample on (1, C, H, W) at the same taps (align_corners=False:
        # pixel x sits at (2x + 1) / W - 1): a yardstick, it rounds otherwise
        from mvsnet_tpu_torch.ops.warp import projected_coords
        px, py = projected_coords(hm, Hr, W, row_offset=r0)
        grid = torch.stack([(2 * px + 1) / W - 1, (2 * py + 1) / H - 1], -1)
        grid = grid.reshape(1, D * Hr, W, 2)

        def make(dtype):
            return randn((H, W, C), dtype), hm

        cases.append(dict(
            name="warp" + tag, counter="warp_sharded" if block else "warp",
            kernel=lambda img, h: warp.warp_all_depths(img, h, *block), path=path,
            plain=lambda img, h: warp.warp_all_depths_plain(img, h, *block),
            library=lambda img, _: F.grid_sample(img, grid.to(img.dtype), align_corners=False),
            library_inputs=lambda img, h: (img.movedim(-1, 0)[None].contiguous(), h),
            make=make, bytes=lambda it: (H * W * C + D * Hr * W * C) * it + hm.numel() * 4,
            ops=D * Hr * W * (C * 6 + 25), source="mvsnet_tpu_torch/csrc/warp.cu",
            replaces=replaces))

        def lib_t_inputs(g, h):
            inp = torch.zeros((1, C, H, W), dtype=g.dtype, device=dev, requires_grad=True)
            out = F.grid_sample(inp, grid.to(g.dtype), align_corners=False)
            gout = g.reshape(D, Hr, W, C).permute(3, 0, 1, 2).reshape(1, C, D * Hr, W)
            return out, inp, gout.contiguous()

        cases.append(dict(
            name="warp_transpose" + tag,
            counter="warp_transpose_sharded" if block else "warp_transpose",
            kernel=lambda g, h: warp.warp_transpose(g, h, *t_block), path=path,
            plain=lambda g, h: warp.warp_transpose_plain(g, h, *t_block), f32_out=True,
            deterministic=True,
            # the train step's cotangents are float32 (ops/cost_volume.py)
            path_dtype=torch.float32,
            library=lambda out, inp, gout: torch.autograd.grad(out, inp, gout,
                                                               retain_graph=True),
            library_inputs=lib_t_inputs,
            make=lambda dtype: (randn((D, Hr, W, C), dtype), hm),
            bytes=lambda it: D * Hr * W * C * it + H * W * C * 4 + hm.numel() * 4,
            ops=D * Hr * W * (C * 8 + 25), source="mvsnet_tpu_torch/csrc/warp.cu",
            replaces="mvsnet_tpu/ops/pallas/sweep.py:1701"))

    def add_wgrad(layer, x_shape, g_shape, k, stride, replaces, path=None):
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
            name=f"wgrad:{layer}", counter="wgrad", f32_out=True, path=path,
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
    # the GRU path at R-MVSNet's serving point (1600x1184: features 296x400,
    # D=256): K1 over the 256 planes, then the cells' convs (bias, no ReLU)
    add_cost("cost_volume:gru", g_homs, 296, 400, path="gru")
    for layer, cin, cout in (("gru1_gates", 48, 32), ("gru1_output", 48, 16),
                             ("gru2_gates", 20, 8), ("gru2_output", 20, 4),
                             ("gru3_gates", 6, 4), ("gru3_output", 6, 2), ("prob_conv", 2, 1)):
        add_conv(layer, (1, 296, 400, cin), 3, 1, cout, True, c2s1, relu=False, path="gru")
    # ... and its feature tower at 1184x1600: the image conv (Cin 3) and the
    # first conv at Cin 8
    add_conv("2dconv0_1:gru", (3, 1184, 1600, 3), 3, 1, 8, False, c2s1, path="gru")
    add_conv("2dconv0_2:gru", (3, 1184, 1600, 8), 3, 1, 8, False, c2s1, path="gru")
    # the GRU training path at the bench train_gru point (640x480, "lite":
    # features 120x160x16, D=192, filters 8, 2, 1): K1, K2 and K3 at C = 16;
    # each cell conv forward (no bias: ConvFn), its input gradient (the
    # conv kernel on the flipped, swapped weights) and its weight gradient
    add_cost("cost_volume:train_gru", t_homs, 120, 160, path="train_gru", C=16)
    add_warp(t_homs[0], "mvsnet_tpu/ops/pallas/sweep.py:1599", C=16, path="train_gru")
    for layer, cin, cout in (("gru1_gates", 24, 16), ("gru1_output", 24, 8),
                             ("gru2_gates", 10, 4), ("gru2_output", 10, 2),
                             ("gru3_gates", 3, 2), ("gru3_output", 3, 1), ("prob_conv", 1, 1)):
        name = f"lite_{layer}"
        add_conv(name, (1, 120, 160, cin), 3, 1, cout, False, c2s1, path="train_gru")
        if (cin, cout) != (1, 1):
            add_conv(name + "_dx", (1, 120, 160, cout), 3, 1, cin, False, c2s1,
                     path="train_gru")
        add_wgrad(name, (1, 120, 160, cin), (1, 120, 160, cout), 3, 1, wg1, path="train_gru")

    # the refinement U-Net at the refined-serving point (1152x864 images,
    # "normal"; image + depth + confidence: Cin 5 in its two first convs);
    # bias and ReLU but for the output conv
    d2 = "mvsnet_tpu/ops/pallas/deconv2d.py:185"
    add_conv("2dconv0_1_refine", (1, 864, 1152, 5), 3, 1, 8, True, c2s1, path="refine")
    add_conv("2dconv1_0_refine", (1, 864, 1152, 5), 3, 2, 16, True, c2s2, path="refine")
    add_conv("2dconv5_1_refine", (1, 108, 144, 128), 3, 1, 64, True, c2s1, path="refine")
    add_conv("2dconv8_3_refine", (1, 864, 1152, 8), 3, 1, 32, True, c2s1, path="refine")
    add_conv("2dconv8_4_refine", (1, 864, 1152, 32), 3, 1, 1, True, c2s1, relu=False,
             path="refine")
    add_deconv("2dconv5_0_refine", (1, 54, 72, 128), 64, True, d2, path="refine")
    # ... and at the training point (640x480): the Cin = 5 conv's weight
    # gradient and its input gradient (8 -> 5)
    add_wgrad("2dconv0_1_refine", (1, 480, 640, 5), (1, 480, 640, 8), 3, 1, wg1,
              path="train_refine")
    add_conv("2dconv0_1_refine_dx", (1, 480, 640, 8), 3, 1, 5, False, c2s1, path="train_refine")
    # K2 and K3 with a row offset at the blocked train step's shapes (8g's
    # (1,2,1) mesh at the training point: a depth slab of 96 planes, rows
    # whole, the second rank's slab)
    add_warp(t_homs[0, 96:].contiguous(), "mvsnet_tpu/ops/pallas/sweep.py:1599",
             path="blocks", rows=(0, 120))

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
            simt_text, device = "", {}
            if editioned and dtype == torch.bfloat16:
                turns = {"tc": [], "simt": []}
                for ed in ("tc", "simt", "simt", "tc"):
                    if ed == "tc" and want_ed != "tc":
                        continue
                    turns[ed].append(cuda_time_ms(lambda ed=ed: c["kernel"](*inputs, edition=ed)))
                ms = float(np.mean(turns[want_ed]))
                # device time alone: the wrapper's host time hidden by a graph
                for ed in dict.fromkeys((want_ed, "simt")):
                    device[ed] = graph_ms(lambda ed=ed: c["kernel"](*inputs, edition=ed))
                simt_text = (f"  [{want_ed} {', '.join(f'{t:.4f}' for t in turns[want_ed])}; "
                             f"simt {', '.join(f'{t:.4f}' for t in turns['simt'])}; device "
                             + ", ".join(f"{e} {t:.4f}" for e, t in device.items()))
            else:
                ms = cuda_time_ms(lambda: c["kernel"](*inputs))
            plain_ms = cuda_time_ms(lambda: c["plain"](*inputs), max_iters=10)
            lib_ms = None
            if c["library"] is not None:
                lib_in = c["library_inputs"](*inputs)
                lib_ms = cuda_time_ms(lambda: c["library"](*lib_in))
                if device:
                    # a yardstick: a library call that a graph does not take
                    # leaves its device time unmeasured, not the phase failed
                    try:
                        device["library"] = graph_ms(lambda: c["library"](*lib_in))
                        simt_text += f", library {device['library']:.4f}"
                    except RuntimeError as e:
                        simt_text += f", library not measured ({str(e)[:60]})"
                del lib_in
            if device:
                simt_text += " ms]"
                torch.cuda.empty_cache()
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
                bound_by=bound_by, library_ms=lib_ms,
                device_ms=device.get(c["edition"](dtype)) if device else None)
            del inputs
            torch.cuda.empty_cache()
    failures += backward_repeat(smi, randn, t_homs)
    failures += warp_row_blocks(smi, randn, t_homs[0, 96:].contiguous())
    if failures:
        print("kernel phase FAILED:\n  " + "\n  ".join(failures))
        return 1

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 4 next]", flush=True)
    # ---- 4. inference: 3 requests at the operating point
    cfg = ModelConfig(view_num=3, max_d=192, width=1152, height=864,
                      network_mode="normal", compute_dtype="bfloat16")
    predictor = Predictor(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, per_request, editions, finite, depth, prob = serve_counted(predictor, request)
    if not finite:
        print("inference FAILED: non-finite depth or prob")
        return 1
    peak = peaks["serve"] = torch.cuda.max_memory_allocated()
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

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 5 next]", flush=True)
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

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 6 next]", flush=True)
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
    peak = peaks["train"] = torch.cuda.max_memory_allocated()
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

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 7 next]", flush=True)
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

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 10, 11 next]", flush=True)
    # ---- 10, 11. R-MVSNet serving and training
    g_de = g_cams[:, 0, 1, 3, 3]
    gru_counts = phase10_gru_serving(smi, dev, (g_images, g_cams, g_cams[:, 0, 1, 3, 0],
                                                g_cams[:, 0, 1, 3, 1], g_de))
    if gru_counts is None:
        return 1
    gru_train_counts = phase11_gru_training(smi, dev)
    if gru_train_counts is None:
        return 1

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 12, 13 next]", flush=True)
    # ---- 12, 13. refinement: serving and training
    refine_counts = phase12_refined_serving(smi, dev, request)
    if refine_counts is None:
        return 1
    refine_train_counts = phase13_refined_training(smi, dev)
    if refine_train_counts is None:
        return 1

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 8 next]", flush=True)
    # ---- 8. multi-GPU serving and training
    multi = phase8(smi, dev, randn, homs, request, peaks)
    if multi is None:
        return 1
    k1s, block_counts = multi

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 9 next]", flush=True)
    # ---- 9. the training driver, resuming, convergence, the bench script
    if not (phase9_driver(smi, dev) and phase9_convergence(smi, dev)):
        return 1
    from mvsnet_tpu_torch import bench

    print("phase 9d: the port's bench script (python -m mvsnet_tpu_torch.bench --metric all):")
    for name in sorted(bench.POINTS):
        print(json.dumps(bench.POINTS[name](dev)), flush=True)
    lite_step = bench.train_case(dev)
    lite_step()
    print_profile("bench train step (lite)", *profile_device(lite_step))
    del lite_step
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 14 next]", flush=True)
    # ---- 14. the serving drivers with refinement
    if not phase14_drivers(smi, dev):
        return 1

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 15 next]", flush=True)
    # ---- 15. TF-checkpoint import, the chain to a PLY, fusion at full size
    cloud = phase15(smi, dev, request)
    if cloud is None:
        return 1

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: phase 16 next]", flush=True)
    # ---- 16. from a DTU-layout scan to a scored cloud; the native codec
    if not phase16(smi, dev, cloud):
        return 1
    del cloud

    print(f"[{time.perf_counter() - t_start:.1f} s since the start: the records next]", flush=True)
    # ---- records: launches from the training run of phase 6, the GRU rows'
    # from the requests of phase 10 and the steps of phase 11; K1s's from
    # the latency requests of phase 8 (all ranks); the refinement rows' from
    # the refined requests of phase 12 and the refined steps of phase 13
    path_counts = {None: train_launches, "gru": gru_counts, "train_gru": gru_train_counts,
                   "refine": refine_counts, "train_refine": refine_train_counts,
                   "blocks": block_counts}
    out = []
    for c in cases:
        r = records[(c["name"], str(c.get("path_dtype", torch.bfloat16)).replace("torch.", ""))]
        launches = path_counts[c.get("path")][c["counter"]]
        out.append(dict(name=c["name"], route="cuda", source=c["source"],
                        replaces=c["replaces"], launches=launches, **r))
    return report(out + [k1s])


def phase8(smi, dev, randn, homs, request, peaks=None):
    """Phase 8; returns K1s's kernel record and the launch counts of 8g's
    bf16 blocked steps summed over ranks, or None on failure. `peaks`:
    phase 4's and phase 6's peak memory (bytes), printed beside the ranks'."""
    backend, n, serve_mesh = serving_setup()
    k1s = phase8_sharded_cost(smi, randn, homs, serve_mesh)
    if k1s is None:
        return None
    big = (train_scene(480, 640, 192, seed=2), BIG_TRAIN_ARGS)
    ranks = phase8_ranks(smi, dev, request, backend, n, big)
    if ranks is None:
        return None
    launches, refs, two = ranks
    block_counts = phase8_blocks(smi, dev, request, peaks or {}, refs=refs, two=two)
    if block_counts is None:
        return None
    return dict(name="cost_volume_sharded", route="cuda",
                source="mvsnet_tpu_torch/csrc/cost_volume.cu",
                replaces="mvsnet_tpu/ops/pallas/sweep.py:2032", launches=launches,
                **k1s), block_counts


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
