"""Native (C++) libraries, loaded with ctypes: the point-cloud
consolidation (counterpart of mvsnet_tpu/native/__init__.py) and the image
codec (`jpeg.cpp`, wrapped by `native/codec.py`).

Each source builds at first use with `g++ -O3 -fopenmp -shared -fPIC`
into `mvsnet_tpu_torch/_build/` (git-ignored), named by a hash of the
source and the flags; nothing is built next to the source. Where a
library cannot be built or loaded, its functions raise, naming the
compiler: they never fall back to numpy quietly. The numpy versions
(`voxel_downsample_plain`, `radius_outlier_removal_plain`, and the codec's
in `io/jpeg.py` and `io/images.py`) are the plain versions the tests and
`chip_smoke.py` hold the libraries against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

DIR = Path(__file__).resolve().parent
SOURCES = {"pointcloud": DIR / "pointcloud.cpp", "jpeg": DIR / "jpeg.cpp"}
SRC = SOURCES["pointcloud"]
BUILD_DIR = DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS = {}


def compiler(name: str = "pointcloud") -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"the native library is built from {SOURCES[name].name} with g++, "
                           "which is not installed")
    return cxx


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCES[name].read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str = "pointcloud") -> Path:
    """Compile `SOURCES[name]` unless it is built; returns the library's
    path. Raises with the compiler's output on failure."""
    src, target = SOURCES[name], _target(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = compiler(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(src), "-o", tmp]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} with {cxx} failed: {e}") from e
    if out.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} with {' '.join(cmd)} failed "
                           f"(exit {out.returncode}):\n{out.stderr[-2000:]}")
    os.replace(tmp, target)
    return target


_SIGNATURES = {
    "pointcloud": {
        "voxel_downsample": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                              ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]),
        "radius_outlier_mask": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64,
                                                 ctypes.c_double, ctypes.c_int64,
                                                 ctypes.c_void_p]),
        "native_pointcloud_abi_version": (ctypes.c_int, []),
    },
    "jpeg": {
        "jpeg_header": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.c_char_p, ctypes.c_int64]),
        "jpeg_decode": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.c_char_p, ctypes.c_int64]),
        "jpeg_encode": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                         ctypes.c_int64]),
        "png_unfilter": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_void_p]),
        "native_codec_abi_version": (ctypes.c_int, []),
    },
}


def load(name: str = "pointcloud") -> ctypes.CDLL:
    """The library built from `SOURCES[name]`, built first where it is
    missing. Its calls release the GIL (ctypes.CDLL), so threads run them
    in parallel."""
    with _LOCK:
        if name not in _LIBS:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the native library {path} "
                                   f"(built by {compiler(name)}) failed: {e}") from e
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS[name]


def has_native() -> bool:
    """Whether every native library builds and loads here (the JAX
    package's `has_native`); the port's functions raise where they do not."""
    try:
        for name in SOURCES:
            load(name)
    except RuntimeError:
        return False
    return True


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _points(points) -> np.ndarray:
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), not {points.shape}")
    return points


def _colors(colors, n: int) -> Optional[np.ndarray]:
    if colors is None:
        return None
    colors = np.ascontiguousarray(colors, dtype=np.uint8)
    if colors.shape != (n, 3):
        raise ValueError(f"colors must be ({n}, 3), not {colors.shape}")
    return colors


def voxel_downsample(points: np.ndarray, colors: Optional[np.ndarray],
                     voxel_size: float) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points (and colors, rounded half up) per occupied voxel, in
    the library's hash order."""
    points = _points(points)
    n = len(points)
    if n == 0 or voxel_size <= 0:
        return points, colors
    colors = _colors(colors, n)
    lib = load()
    m = lib.voxel_downsample(_ptr(points), _ptr(colors), n, voxel_size, None, None)
    out_p = np.empty((m, 3), np.float32)
    out_c = np.empty((m, 3), np.uint8) if colors is not None else None
    lib.voxel_downsample(_ptr(points), _ptr(colors), n, voxel_size, _ptr(out_p), _ptr(out_c))
    return out_p, out_c


def radius_outlier_removal(points: np.ndarray, radius: float,
                           min_neighbors: int) -> np.ndarray:
    """Boolean keep-mask: >= min_neighbors points in the 27-cell
    neighbourhood of each point's `radius`-sized voxel."""
    points = _points(points)
    n = len(points)
    if n == 0:
        return np.zeros((0,), bool)
    mask = np.empty((n,), np.uint8)
    load().radius_outlier_mask(_ptr(points), n, radius, min_neighbors, _ptr(mask))
    return mask.astype(bool)


def _voxel_keys(points: np.ndarray, size: float) -> np.ndarray:
    """floor(p * (1 / size)) in float64, as `key_of` in pointcloud.cpp
    computes it (the JAX package's numpy version divides in float32, which
    can put a point on a boundary in the next cell)."""
    return np.floor(points.astype(np.float64) * (1.0 / size)).astype(np.int64)


def voxel_downsample_plain(points, colors, voxel_size: float):
    """numpy version of `voxel_downsample` (native/__init__.py:105-118 of
    the JAX package) with the library's arithmetic: float64 sums in input
    order scaled by 1 / count; points come in the order of the sorted voxel
    keys."""
    points = _points(points)
    if len(points) == 0 or voxel_size <= 0:
        return points, colors
    colors = _colors(colors, len(points))
    _, inverse, counts = np.unique(_voxel_keys(points, voxel_size), axis=0,
                                   return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    m = len(counts)
    inv = (1.0 / counts.astype(np.float64))[:, None]
    out_p = np.zeros((m, 3), np.float64)
    np.add.at(out_p, inverse, points.astype(np.float64))
    out_p = (out_p * inv).astype(np.float32)
    out_c = None
    if colors is not None:
        acc = np.zeros((m, 3), np.float64)
        np.add.at(acc, inverse, colors.astype(np.float64))
        out_c = np.clip(acc * inv + 0.5, 0, 255).astype(np.uint8)
    return out_p, out_c


def radius_outlier_removal_plain(points, radius: float, min_neighbors: int) -> np.ndarray:
    """numpy version of `radius_outlier_removal` (native/__init__.py:136-148
    of the JAX package)."""
    points = _points(points)
    if len(points) == 0:
        return np.zeros((0,), bool)
    uniq, inverse, counts = np.unique(_voxel_keys(points, radius), axis=0,
                                      return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    cell_count = {tuple(k): int(c) for k, c in zip(uniq.tolist(), counts)}
    neighbor_total = np.zeros(len(uniq), np.int64)
    for i, (x, y, z) in enumerate(uniq.tolist()):
        neighbor_total[i] = sum(cell_count.get((x + dx, y + dy, z + dz), 0)
                                for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    return neighbor_total[inverse] >= min_neighbors
