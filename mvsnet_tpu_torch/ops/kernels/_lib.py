"""Builds the CUDA sources under `mvsnet_tpu_torch/csrc/` and loads them.

Each `csrc/<name>.cu` compiles with `nvcc` for sm_90a into a shared library
with a plain C interface, loaded with `ctypes`. That takes seconds, where a
source that includes PyTorch's headers takes minutes. Libraries land in
`mvsnet_tpu_torch/_build/` (git-ignored), named by a hash of their sources
and flags, at first use; all missing ones build at once, one `nvcc` each,
started together.

Every C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()`; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("cost_volume", "conv", "deconv", "group_norm", "gru_step", "warp", "wgrad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# name -> what nvcc printed (register, shared-memory and spill lines), for
# the libraries this process built.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found: the port's CUDA kernels are "
                                "built from source with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every library in `names` that is not built yet, in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def launcher(name: str, argtypes, entry: str = "launch"):
    """`<name>_<entry>` from the library built from `csrc/<name>.cu`,
    building every missing library first."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    fn = getattr(lib, f"{name}_{entry}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh DType


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {t.dtype}")
    return code


def require_cuda(*tensors) -> None:
    """The kernels take contiguous, 16-byte aligned CUDA tensors on one
    device (they read channels in 16-byte vectors)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned tensors")
