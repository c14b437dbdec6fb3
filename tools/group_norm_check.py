"""The group-norm kernel pair (`ops/kernels/norm.py`) at the five level
shapes of UNetDS2GN at DTU's 1600x1184 with N=5 views, on one card: the
pair against the plain code of `layers.group_norm_core` (bits that
differ), its time beside its bound (x read twice and y written once, 6
bytes an element, at 3.35 TB/s) through the wrapper and on the device
alone (20 calls in a CUDA graph), the stats kernel's time alone, the host's time a
call, the plain version's time, and the library yardstick's
(`torch.nn.functional.group_norm` on the bf16 map viewed channels-first),
by CUDA events; then the whole tower with the kernels against the tower
on the plain norms.

    python3 tools/group_norm_check.py      # on a machine with an H100

Prints the card and one line a level; exits 1 if any bit differs.
"""
import math
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from mvsnet_tpu_torch.models.feature_net import UNetDS2GN  # noqa: E402
from mvsnet_tpu_torch.models.layers import group_norm_core, reset_parameters  # noqa: E402
from mvsnet_tpu_torch.ops.kernels import _lib, norm  # noqa: E402
from mvsnet_tpu_torch.utils import profiling  # noqa: E402

N = 5
# (rows, columns, channels) of the tower's levels; G = C / 8
LEVELS = [(1184 >> lv, 1600 >> lv, 8 << lv) for lv in range(5)]
# the tower's norms a level (2dconv*_* and conv9/10_* by their outputs' level)
NORMS = [5, 9, 8, 6, 3]


def plain(x, gamma, beta, groups, relu):
    """`group_norm_core`'s plain code: a call that records a gradient."""
    with torch.enable_grad():
        return group_norm_core(x, gamma.requires_grad_(), beta, groups, 1e-5,
                               relu=relu).detach()


def host_ms(fn, calls=200):
    """Host ms a call over `calls` calls with no wait between them (the
    card's queue is the limit only where a call's device time is longer)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def main() -> int:
    import chip_smoke

    if not torch.cuda.is_available():
        print("group_norm_check: no CUDA device", file=sys.stderr)
        return 1
    _lib.build_all()
    print(chip_smoke.smi_line())
    print(_lib.build_logs.get("group_norm", "").strip()[-3000:])
    dev = torch.device("cuda", 0)
    ok = True
    total = {"kernel": 0.0, "device": 0.0, "bound": 0.0, "plain": 0.0}
    for lv, (h, w, C) in enumerate(LEVELS):
        G = C // 8
        g = torch.Generator(device=dev).manual_seed(lv)
        x = (torch.randn((N, h, w, C), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
        gamma = 0.5 + torch.rand((C,), generator=g, device=dev)
        beta = torch.randn((C,), generator=g, device=dev)
        with torch.inference_mode():
            got = group_norm_core(x, gamma, beta, G, 1e-5, relu=True)
        want = plain(x, gamma.clone(), beta, G, True)
        differ = int((got != want).sum())
        ok = ok and differ == 0
        del got, want
        with torch.inference_mode():
            kernel_ms = [chip_smoke.cuda_time_ms(
                lambda: norm.group_norm(x, gamma, beta, G, 1e-5, relu=True), budget_s=0.3)
                for _ in range(2)]
            device_ms = chip_smoke.graph_ms(
                lambda: norm.group_norm(x, gamma, beta, G, 1e-5, relu=True))
            stats_ms = chip_smoke.cuda_time_ms(lambda: norm.group_norm_stats(x), budget_s=0.2)
            plain_ms = chip_smoke.cuda_time_ms(
                lambda: norm.group_norm_apply_plain(x, norm.group_norm_stats_plain(x), h * w,
                                                    gamma, beta, G, 1e-5, True), max_iters=5)
            xc = x.permute(0, 3, 1, 2)
            lib_ms = chip_smoke.cuda_time_ms(
                lambda: F.group_norm(xc, G, gamma.to(torch.bfloat16), beta.to(torch.bfloat16),
                                     1e-5), max_iters=10)
            host = {"kernels": host_ms(lambda: norm.group_norm(x, gamma, beta, G, 1e-5,
                                                               relu=True)),
                    "plain": host_ms(lambda: norm.group_norm_apply_plain(
                        x, norm.group_norm_stats_plain(x), h * w, gamma, beta, G, 1e-5, True))}
        bound_ms = 6 * x.numel() / 3.35e12 * 1e3
        total["device"] += NORMS[lv] * device_ms
        total["kernel"] += NORMS[lv] * kernel_ms[0]
        total["bound"] += NORMS[lv] * bound_ms
        total["plain"] += NORMS[lv] * plain_ms
        print(f"level {lv} N{N} h{h} w{w} C{C} G{G} bf16 ReLU: kernels {kernel_ms[0]:.4f}, "
              f"{kernel_ms[1]:.4f} ms, device {device_ms:.4f} ms (stats alone {stats_ms:.4f}), "
              f"host a call {host['kernels']:.4f} ms (plain {host['plain']:.4f}), bound "
              f"{bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms; "
              f"{differ} of {x.numel()} elements differ from the plain code "
              f"({'ok' if differ == 0 else 'FAIL'})", flush=True)
        del x
        torch.cuda.empty_cache()
    print(f"the tower's {sum(NORMS)} norms: kernels {total['kernel']:.3f} ms (device "
          f"{total['device']:.3f}), bound "
          f"{total['bound']:.3f} ms, plain {total['plain']:.3f} ms")

    tower = UNetDS2GN("normal", dtype=torch.bfloat16)
    reset_parameters(tower, 5)
    tower = tower.to(dev).eval()
    x = torch.randn((N, 1184, 1600, 3), generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    with torch.inference_mode():
        before = profiling.counters()["launches.group_norm"]
        got = tower(x)
        launches = profiling.counters()["launches.group_norm"] - before
        tower_ms = chip_smoke.cuda_time_ms(lambda: tower(x), budget_s=0.5)
    with torch.enable_grad():
        want = tower(x).detach()
        plain_tower_ms = chip_smoke.cuda_time_ms(lambda: tower(x), max_iters=5)
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    ok = ok and launches == 2 * sum(NORMS) and err <= chip_smoke.TOL[torch.bfloat16] * scale
    print(f"tower N{N} 1184x1600 bf16: {tower_ms:.3f} ms with the kernels ({launches} "
          f"launches), {plain_tower_ms:.3f} ms on the plain norms; max abs difference {err:.3e} "
          f"of values up to {scale:.3f}; bits that differ {int((got != want).sum())} of "
          f"{math.prod(got.shape)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
