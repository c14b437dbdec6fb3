"""PFM (portable float map) IO (a copy of mvsnet_tpu/io/pfm.py).

Format-compatible with the reference's reader/writer
(reference: mvsnet/preprocess.py:294-356): 'Pf'/'PF' header, width height,
negative scale = little-endian, rows stored bottom-up.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from mvsnet_tpu_torch.io.filesystem import open_file


def load_pfm(path_or_file):
    """Read a PFM file into (H, W) or (H, W, 3) float32 (top-down rows)."""
    f = open_file(path_or_file, "rb") if isinstance(path_or_file, (str, bytes)) else path_or_file
    try:
        header = f.readline().decode("ascii").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_line = f.readline().decode("ascii")
        m = re.match(r"^(\d+)\s+(\d+)\s*$", dim_line)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        dtype = "<f" if scale < 0 else ">f"
        data = np.frombuffer(f.read(), dtype=dtype)
        shape = (height, width, 3) if color else (height, width)
        data = data.reshape(shape)
        return np.ascontiguousarray(np.flipud(data)).astype(np.float32)
    finally:
        if isinstance(path_or_file, (str, bytes)):
            f.close()


def write_pfm(path, image, scale: float = 1.0) -> None:
    """Write float32 (H, W[, 1|3]) to PFM (rows flipped, little-endian)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("Image dtype must be float32.")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2:
        color = False
    else:
        raise ValueError("Image must be HxW, HxWx1 or HxWx3.")

    image = np.flipud(image)
    if image.dtype.byteorder == "<" or (image.dtype.byteorder == "=" and sys.byteorder == "little"):
        scale = -scale
    with open_file(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        f.write(f"{scale:f}\n".encode("ascii"))
        f.write(image.tobytes())
