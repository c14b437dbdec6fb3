"""Where the cost volume's time goes (kernel K1) at the inference point
(1152x864, D=192, V=3, features 216x288x32, bf16), on one card: the
kernel's first design (`tools/cost_volume_split.cu`) as it was,
store-only and loads-only, beside the kernel of `csrc/cost_volume.cu`, in
turns (each mode twice), by CUDA events.

    python3 tools/cost_volume_split.py      # on a machine with an H100

Prints the card, each mode's times and whether the first design and the
new one agree with the plain version (tolerance as chip_smoke.py's bf16).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from mvsnet_tpu_torch.ops.geometry import homographies_for_views  # noqa: E402
from mvsnet_tpu_torch.ops.kernels import _lib, sweep  # noqa: E402
from mvsnet_tpu_torch.predict import depth_params_from_cams  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("cost_volume_split: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line())
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _lib.BUILD_DIR / "cost_volume_split.so"
    subprocess.run([_lib.nvcc_path(), *_lib.NVCC_FLAGS, "-o", str(so),
                    str(ROOT / "tools" / "cost_volume_split.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.first_cost.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    H, W, C, D = 216, 288, 32, 192
    _, cams = chip_smoke.scene(1, 3, 864, 1152, D, seed=0)
    ds, di, _, _ = depth_params_from_cams(cams)
    homs = homographies_for_views(torch.from_numpy(cams).to(dev), D, torch.from_numpy(ds).to(dev),
                                  torch.from_numpy(di).to(dev))[:, 0].contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    ref = torch.randn((H, W, C), generator=gen, device=dev).to(torch.bfloat16)
    views = torch.randn((2, H, W, C), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((D, H, W, C), dtype=torch.bfloat16, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def first(mode):
        return lambda: lib.first_cost(mode, ref.data_ptr(), views.data_ptr(), homs.data_ptr(),
                                    out.data_ptr(), 2, D, H, W, C, stream)

    want = sweep.cost_volume_plain(ref, views, homs).float()
    tol = chip_smoke.TOL[torch.bfloat16] * max(1.0, want.abs().max().item())
    first(0)()
    torch.cuda.synchronize()
    errs = {"first design": (out.float() - want).abs().max().item(),
            "new": (sweep.cost_volume(ref, views, homs).float() - want).abs().max().item()}
    print("max abs err against the plain version: " + ", ".join(
        f"{k} {v:.3e} ({'ok' if v <= tol else 'FAIL'})" for k, v in errs.items()))
    modes = [("first design", first(0)), ("store-only", first(1)), ("loads-only", first(2)),
             ("csrc/cost_volume.cu", lambda: sweep.cost_volume(ref, views, homs))]
    times = {name: [] for name, _ in modes}
    for name, fn in modes + modes[::-1]:
        times[name].append(chip_smoke.cuda_time_ms(fn, budget_s=0.3))
    for name, ts in times.items():
        print(f"  {name:20s} " + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    return 0 if all(v <= tol for v in errs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
