"""The native image codec (`native/jpeg.cpp`): baseline JPEG decode and
encode, and the PNG row unfilter, bit for bit equal to their plain
versions (`io/jpeg.decode`, `io/jpeg.encode`, `io/images._unfilter`).

ctypes releases the GIL for the length of each call, so the data loader's
threads decode their images in parallel. The library builds with g++ at
first use (`native.build("jpeg")`); without a compiler these functions
raise, naming it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mvsnet_tpu_torch import native
from mvsnet_tpu_torch.io.jpeg import SUBSAMPLING

_ERR = 512
_SAMPLING = {name: i for i, name in enumerate(SUBSAMPLING)}   # 4:4:4 0, 4:2:2 1, 4:2:0 2


def _lib():
    return native.load("jpeg")


def _raise(err):
    raise ValueError(err.value.decode(errors="replace"))


def jpeg_shape(data: bytes):
    """(height, width, channels) from a JPEG's frame header."""
    hwc = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(_ERR)
    if _lib().jpeg_header(data, len(data), hwc.ctypes.data, err, _ERR):
        _raise(err)
    return tuple(int(x) for x in hwc)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG as uint8 (H, W) or (H, W, 3); unsupported kinds raise
    `ValueError` naming them."""
    data = bytes(data)
    H, W, C = jpeg_shape(data)
    out = np.empty((H, W) if C == 1 else (H, W, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if _lib().jpeg_decode(data, len(data), out.ctypes.data, err, _ERR):
        _raise(err)
    return out


def encode_jpeg(image, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """A uint8 (H, W) or (H, W, 3) image as a baseline JFIF JPEG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"JPEG samples must be uint8, not {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"cannot write an image of shape {image.shape} as a JPEG")
    if subsampling not in _SAMPLING:
        raise ValueError(f"unknown JPEG subsampling {subsampling!r} "
                         f"(one of {', '.join(_SAMPLING)})")
    image = np.ascontiguousarray(image)
    H, W = image.shape[:2]
    C = 1 if image.ndim == 2 else 3
    lib, err = _lib(), ctypes.create_string_buffer(_ERR)
    cap = 4096 + image.size
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(image.ctypes.data, H, W, C, int(quality), _SAMPLING[subsampling],
                            out.ctypes.data, cap, err, _ERR)
        if n < 0:
            _raise(err)
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def png_unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """The (H, stride) scanlines of a decompressed PNG (H rows of a filter
    byte and `stride` bytes) with each row's filter undone."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if bpp < 1 or stride % bpp:
        raise ValueError(f"PNG rows of {stride} bytes do not hold pixels of {bpp} bytes")
    if raw.size != H * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not {H} rows of {stride + 1}")
    out = np.empty((H, stride), np.uint8)
    row = _lib().png_unfilter(raw.ctypes.data, H, stride, bpp, out.ctypes.data)
    if row >= 0:
        raise ValueError(f"unknown PNG filter type {raw[row * (stride + 1)]}")
    return out
