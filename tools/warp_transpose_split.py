"""Where the transposed warp's time goes (kernel K3) at the training point
(640x480, D=192, features 120x160x32), on one card: the kernel of
`csrc/warp.cu` whole (its wrapper: the plan, the gather, the run sums),
and a copy of the gather built without the owners' sums (the staging of
cotangents, the tables and grids, the barriers and the run sums only, on a
plan made once beforehand), float32 and bfloat16, in turns (each twice), by
CUDA events; and the plan alone.

    python3 tools/warp_transpose_split.py      # on a machine with an H100

Prints the card, each mode's times, and whether the whole kernel agrees
with the plain version (tolerance as chip_smoke.py's float32).
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
from mvsnet_tpu_torch.ops.kernels import _lib, warp  # noqa: E402
from mvsnet_tpu_torch.predict import depth_params_from_cams  # noqa: E402

OWNER = "    if (mine) {\n      // the owner's window"


def build_without_owners() -> ctypes.CDLL:
    """csrc/warp.cu with the owners' block switched off, built beside the
    port's libraries."""
    src = (_lib.CSRC / "warp.cu").read_text()
    assert src.count(OWNER) == 1, "the owners' block moved: update this tool"
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _lib.BUILD_DIR / "warp_no_owners.cu"
    cu.write_text(src.replace(OWNER, OWNER.replace("(mine)", "(false && mine)")))
    so = _lib.BUILD_DIR / "warp_no_owners.so"
    subprocess.run([_lib.nvcc_path(), *_lib.NVCC_FLAGS, f"-I{_lib.CSRC}", "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    if not torch.cuda.is_available():
        print("warp_transpose_split: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line())
    bare = build_without_owners().warp_transpose_launch
    bare.argtypes = warp._TRANSPOSE_ARGTYPES
    dev = torch.device("cuda", 0)
    D, H, W, C = 192, 120, 160, 32
    _, cams, _, _ = chip_smoke.train_scene(480, 640, D, seed=2)
    ds, di, _, _ = depth_params_from_cams(cams)
    homs = homographies_for_views(torch.from_numpy(cams).to(dev), D, torch.from_numpy(ds).to(dev),
                                  torch.from_numpy(di).to(dev))[0, 0].contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    segments = warp.transpose_segments(D, H, W, C, sms)
    gen = torch.Generator(device=dev).manual_seed(0)
    inv, wsign = warp.transpose_plan(homs, H, W)
    part = torch.empty((segments, H, W, C), device=dev)
    out = torch.empty((H, W, C), device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    print(f"K3 at {D}x{H}x{W}x{C}: {segments} depth runs on {sms} SMs")
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn((D, H, W, C), generator=gen, device=dev).to(dtype)
        got = warp.warp_transpose(g, homs)
        err = (got - warp.warp_transpose_plain(g, homs)).abs().max().item()
        ok = err <= chip_smoke.TOL[torch.float32] * max(1.0, got.abs().max().item())

        def no_owners(g=g):
            e = bare(_lib.dtype_code(g), g.data_ptr(), homs.data_ptr(), inv.data_ptr(),
                     wsign.data_ptr(), out.data_ptr(), part.data_ptr(), segments, D, H, W, C,
                     stream)
            assert e == 0, e
        modes = {"whole": lambda g=g: warp.warp_transpose(g, homs), "without owners": no_owners}
        times = {m: [] for m in modes}
        for m in ("whole", "without owners", "without owners", "whole"):
            times[m].append(chip_smoke.cuda_time_ms(modes[m]))
        tag = str(dtype).replace("torch.", "")
        print(f"  {tag:8s} " + "; ".join(f"{m} {', '.join(f'{t:.4f}' for t in ts)} ms"
                                          for m, ts in times.items())
              + f"; whole vs plain max abs err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    plan_ms = chip_smoke.cuda_time_ms(lambda: warp.transpose_plan(homs, H, W))
    print(f"  plan kernel alone (with its wrapper) {plan_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
