"""The per-pixel cost volume (CasMVSNet's, `ops/kernels/sweep.pixel_cost_volume`)
at the three stage shapes of DTU's 1600x1184 with N=5 views, bf16, on one
card: the kernel against its plain version, its time beside its bound
(its inputs read once and its volume written once at 3.35 TB/s), the
plain version's time, and a library yardstick's: `grid_sample` warps of
each view and the variance in PyTorch (`mvs_bench.reference.casmvsnet.
cost_volume`, float32 maps), by CUDA events.

    python3 tools/pixel_cost_volume_check.py      # on a machine with an H100

Prints the card and one line a stage; exits 1 if the kernel and the plain
version disagree beyond chip_smoke.py's bf16 tolerance.
"""
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from mvs_bench import generate  # noqa: E402
from mvs_bench.reference import casmvsnet as ref  # noqa: E402
from mvsnet_tpu_torch.ops.geometry import pixel_projections  # noqa: E402
from mvsnet_tpu_torch.ops.kernels import _lib, sweep  # noqa: E402

# (D, h, w, C) of the three stages
STAGES = [(48, 296, 400, 32), (32, 592, 800, 16), (8, 1184, 1600, 8)]


def inputs(stage, dev):
    """Seeded bf16 features of 5 views, plane depths centred on a smooth
    depth map 2.65 mm x the stage's ratio apart, a ring rig's projections."""
    D, h, w, C = STAGES[stage]
    g = torch.Generator(device=dev).manual_seed(stage)
    ref_f = torch.randn((h, w, C), generator=g, device=dev).to(torch.bfloat16)
    views = torch.randn((4, h, w, C), generator=g, device=dev).to(torch.bfloat16)
    cams = torch.as_tensor(generate.quarter_cams(generate.make_rig(5, 1600, 1184, 425.0, 2.65,
                                                                   192)), device=dev)
    proj = pixel_projections(cams[None], 2.0 ** stage)[:, 0].contiguous()
    center = 680.0 + 60.0 * F.interpolate(torch.randn((1, 1, h // 16, w // 16), generator=g,
                                                      device=dev), size=(h, w),
                                          mode="bilinear")[0, 0]
    step = 2.65 * ref.RATIOS[stage]
    planes = center + step * (torch.arange(D, device=dev)[:, None, None] - D / 2)
    return ref_f, views, planes.contiguous(), proj


def least_ms(stage, per_pixel: bool) -> float:
    D, h, w, C = STAGES[stage]
    nbytes = 5 * h * w * C * 2 + (D * h * w if per_pixel else D) * 4 + 4 * 12 * 4 \
        + D * h * w * C * 2
    return nbytes / 3.35e12 * 1e3


def main() -> int:
    import chip_smoke

    if not torch.cuda.is_available():
        print("pixel_cost_volume_check: no CUDA device", file=sys.stderr)
        return 1
    _lib.build_all()
    print(chip_smoke.smi_line())
    print(_lib.build_logs.get("cost_volume", "").strip()[-1500:])
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for stage in range(3):
        ref_f, views, planes, proj = inputs(stage, dev)
        rows = [("per-pixel", planes)]
        if stage == 0:
            rows.append(("uniform", planes[:, 0, 0].contiguous()))
        for kind, pl in rows:
            got = sweep.pixel_cost_volume(ref_f, views, pl, proj).float()
            want = sweep.pixel_cost_volume_plain(ref_f, views, pl, proj).float()
            err = (got - want).abs().max().item()
            tol = chip_smoke.TOL[torch.bfloat16] * max(1.0, want.abs().max().item())
            ok = ok and err <= tol
            del got, want
            kernel_ms = [chip_smoke.cuda_time_ms(
                lambda: sweep.pixel_cost_volume(ref_f, views, pl, proj), budget_s=0.3)
                for _ in range(2)]
            plain_ms = chip_smoke.cuda_time_ms(
                lambda: sweep.pixel_cost_volume_plain(ref_f, views, pl, proj), max_iters=3)
            cf = [t.float().permute(2, 0, 1)[None] for t in (ref_f, *views)]
            full = pl if pl.ndim == 3 else pl[:, None, None].expand(-1, *ref_f.shape[:2])
            lib_ms = chip_smoke.cuda_time_ms(
                lambda: ref.cost_volume(cf[0], cf[1:], proj[:, None], full[None]), max_iters=3)
            D, h, w, C = STAGES[stage]
            print(f"stage {stage + 1} {kind} D{D} h{h} w{w} C{C} V5: kernel "
                  f"{kernel_ms[0]:.4f}, {kernel_ms[1]:.4f} ms, bound "
                  f"{least_ms(stage, kind == 'per-pixel'):.4f} ms (bytes), plain {plain_ms:.4f} ms,"
                  f" library {lib_ms:.4f} ms, max abs err {err:.3e} "
                  f"({'ok' if err <= tol else 'FAIL'})", flush=True)
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
