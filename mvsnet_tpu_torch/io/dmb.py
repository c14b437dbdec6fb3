"""Gipuma .dmb binary image IO (a copy of mvsnet_tpu/io/dmb.py; reference:
depthfusion.py:28-64).

Layout: 4 little-endian int32 (type=1, height, width, channels) followed by
float32 data in column-major (Fortran) order with shape (W, H, C).
"""

from __future__ import annotations

import struct

import numpy as np
from mvsnet_tpu_torch.io.filesystem import open_file


def read_dmb(path):
    with open_file(path, "rb") as f:
        _image_type, height, width, channels = struct.unpack("<iiii", f.read(16))
        # frombuffer, not fromfile: works on remote/fsspec file objects too
        data = np.frombuffer(f.read(), np.float32)
    data = data.reshape((width, height, channels), order="F")
    return np.transpose(data, (1, 0, 2)).squeeze()


def write_dmb(path, image) -> None:
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3:
        channels = image.shape[2]
        data = np.transpose(image, (2, 0, 1)).squeeze()
    else:
        channels = 1
        data = image
    with open_file(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, image.shape[0], image.shape[1], channels))
        f.write(np.ascontiguousarray(data).tobytes())
