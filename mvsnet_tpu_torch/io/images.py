"""Image and depth-PNG IO (counterpart of mvsnet_tpu/io/images.py; reference:
mvs_cluster.py:72-89, mvs_data_generation/utils.py:197-219,
preprocess.py:182-270).

PNGs are written by the port's own encoder (`encode_png`: numpy and
zlib, 8- or 16-bit grayscale, RGB or RGBA, no filter), always, so the
depth, confidence and image PNGs come out the same on a machine without an
image codec; `decode_png` reads them back, and any non-interlaced 8- or
16-bit PNG. JPEGs go through `imageio`, imported inside `_imread` and
`_imwrite`, never with the module: a machine without it (the card machine
has no image codec) can still import the data plane and write PNGs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mvsnet_tpu_torch.io import filesystem as fs
from mvsnet_tpu_torch.io.filesystem import is_remote, open_file

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (grayscale, RGB, grayscale + alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError:
        try:
            import imageio
        except ImportError:
            raise ImportError("reading and writing JPEG images needs the 'imageio' package, "
                              "which is not installed") from None
    return imageio


def _imread(path):
    imageio = _imageio()
    if is_remote(path):
        with open_file(path, "rb") as f:
            ext = "." + str(path).rsplit(".", 1)[-1]
            return imageio.imread(f.read(), format=ext)
    return imageio.imread(path)


def _imwrite(path, arr):
    imageio = _imageio()
    if is_remote(path):
        ext = "." + str(path).rsplit(".", 1)[-1]
        data = imageio.imwrite("<bytes>", arr, format=ext)
        with open_file(path, "wb") as f:
            f.write(data)
    else:
        imageio.imwrite(path, arr)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image) -> bytes:
    """A PNG of a uint8 or uint16 (H, W), (H, W, 3) or (H, W, 4) array:
    grayscale, RGB or RGBA at the array's bit depth, every row unfiltered,
    zlib level 6."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    channels = 1 if image.ndim == 2 else image.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}.get(channels) if image.ndim in (2, 3) else None
    if color_type is None:
        raise ValueError(f"cannot write an image of shape {image.shape} as a PNG")
    H, W = image.shape[:2]
    samples = np.ascontiguousarray(image, ">u2" if image.dtype == np.uint16 else np.uint8)
    rows = samples.reshape(H, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8 * image.itemsize, color_type, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """The (H, stride) scanlines of a decompressed PNG with each row's
    filter undone (PNG spec section 9). None, Sub and Up are vectorised;
    Average and Paeth run byte by byte."""
    raw = raw.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, cur = raw[y, 0], raw[y, 1:].copy()
        if kind == 1:
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur += prev
        elif kind in (3, 4):
            row, up = bytearray(cur.tobytes()), prev.tobytes()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                if kind == 3:
                    row[i] = (row[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    row[i] = (row[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.frombuffer(bytes(row), np.uint8)
        elif kind != 0:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced 8- or 16-bit grayscale, RGB, grayscale + alpha or
    RGBA PNG as uint8 or uint16 (H, W) or (H, W, channels)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    W, H, depth, color_type, _, _, interlace = header
    if depth not in (8, 16) or color_type not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color_type}, "
                         f"interlace {interlace}")
    channels, itemsize = _PNG_CHANNELS[color_type], depth // 8
    bpp = channels * itemsize
    rows = _unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8), H, W * bpp, bpp)
    image = rows.view(">u2").astype(np.uint16) if itemsize == 2 else rows
    return image.reshape(H, W) if channels == 1 else image.reshape(H, W, channels)


def write_png(path, image) -> None:
    fs.write_bytes(path, encode_png(image))


def read_png(path) -> np.ndarray:
    return decode_png(fs.read_bytes(path))


def load_image(path):
    """Load an RGB image as uint8 (H, W, 3)."""
    img = np.asarray(_imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def load_depth_png(path):
    """Load a uint16 depth PNG (millimeters) (reference: mvs_cluster.py:78-89):
    through `imageio` where it is installed, else the port's decoder (the
    same array; Average- and Paeth-filtered rows decode byte by byte)."""
    try:
        _imageio()
    except ImportError:
        return read_png(path).astype(np.uint16)
    return np.asarray(_imread(path)).astype(np.uint16)


def write_depth_png(path, depth) -> None:
    """Write depth (mm) clipped to uint16 (reference: preprocess.py:253-260)."""
    write_png(path, np.clip(np.asarray(depth), 0, 65535).astype(np.uint16))


def write_confidence_png(path, prob) -> None:
    """Probability [0,1] -> uint16 PNG (reference: preprocess.py:262-270)."""
    write_png(path, np.clip(np.asarray(prob) * 65535.0, 0, 65535).astype(np.uint16))


def write_image(path, image) -> None:
    """A uint8 image: a PNG by the port's encoder, any other format (JPEG)
    through `imageio`."""
    image = np.asarray(image).astype(np.uint8)
    if str(path).lower().endswith(".png"):
        write_png(path, image)
    else:
        _imwrite(path, image)


def write_inverse_depth_png(path, depth, exp: float = 2.0) -> None:
    """Brightness-inverted depth visualization (reference: preprocess.py:182-196)."""
    max_int = 65535
    img = np.asarray(depth, dtype=np.float64)
    img = img - img.min()
    peak = img.max()
    if peak > 0:
        img = img * (max_int / peak)
    inv = np.power((max_int - img) / max_int, exp) * max_int
    write_png(path, np.clip(inv, 0, max_int).astype(np.uint16))
