"""The port's image codec against the JAX package's and the libraries it
reads through: the plain baseline JPEG codec (`io/jpeg.py`), the native one
(`native/jpeg.cpp` via `native/codec.py`) and the native PNG unfilter.

- The decoders equal JAX's `load_image` (imageio -> PIL -> libjpeg-turbo)
  bit for bit on files written by cv2 and by imageio: 4:4:4, 4:2:2, 4:2:0
  and grayscale, qualities 50/75/95, restart intervals, sizes from 8x8 to
  48x64 that are and are not multiples of the MCU. The largest difference
  is 0.
- The encoder writes imageio's bytes (PIL's quality 75 at 4:2:0), and
  PIL's at the other qualities and samplings.
- Native equals plain bit for bit; unsupported files raise naming their
  kind.
The plain decoder sees nothing larger than 48x64 (a Python Huffman loop).
"""

import io
import struct

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from mvsnet_tpu.io import images as jax_images
from mvsnet_tpu_torch import native
from mvsnet_tpu_torch.io import images, jpeg
from mvsnet_tpu_torch.native import codec

SIZES = [(8, 8), (13, 21), (31, 47), (48, 64)]
CV2_SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
PIL_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _photo(h, w, seed, gray=False):
    """A smooth image with noise: what a camera gives, so that every
    quality leaves AC coefficients in most blocks."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0].copy() if gray else img


def _write(writer, path, img, sampling, quality, restart=0):
    if writer == "cv2":
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        if img.ndim == 3:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[sampling]]
            img = img[..., ::-1]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        assert cv2.imwrite(str(path), img, params)
    else:
        kwargs = {} if img.ndim == 2 else {"subsampling": PIL_SAMPLING[sampling]}
        imageio.imwrite(str(path), img, quality=quality, **kwargs)


CASES = ([(w, s, q, 0) for w in ("cv2", "imageio") for s in ("4:4:4", "4:2:2", "4:2:0", "gray")
          for q in (50, 75, 95)]
         + [("cv2", s, 90, r) for s, r in (("4:2:0", 1), ("4:4:4", 3), ("gray", 2))])


@pytest.mark.parametrize("writer,sampling,quality,restart", CASES,
                         ids=lambda v: str(v))
def test_decoder_equals_jax_load_image(tmp_path, writer, sampling, quality, restart):
    worst = 0
    for k, (h, w) in enumerate(SIZES):
        img = _photo(h, w, seed=k, gray=sampling == "gray")
        path = tmp_path / f"{h}x{w}.jpg"
        _write(writer, path, img, sampling, quality, restart)
        data = path.read_bytes()
        if restart:              # a DRI segment; RSTn markers once there are several MCUs
            assert b"\xff\xdd" in data
            assert (h, w) == (8, 8) or b"\xff\xd0" in data
        want = jax_images.load_image(str(path))
        plain = jpeg.decode(data)
        if plain.ndim == 2:
            plain = np.stack([plain] * 3, axis=-1)
        got = images.load_image(str(path))
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
        worst = max(worst, int(np.abs(got.astype(np.int64) - want).max()),
                    int(np.abs(plain.astype(np.int64) - want).max()))
    print(f"{writer} {sampling} q{quality} restart {restart}: largest difference {worst}")
    assert worst == 0


@pytest.mark.parametrize("sampling", ["4:2:0", "4:2:2", "4:4:4", "gray"])
def test_encoder_writes_imageio_bytes(tmp_path, sampling):
    """The port's `write_image(.jpg)` against imageio's default write (PIL,
    quality 75, 4:2:0); the plain and native encoders against PIL's at
    qualities 50, 75 and 95 in the named sampling. Equal bytes, so equal
    decodes."""
    for k, (h, w) in enumerate(SIZES + [(1, 1), (5, 3)]):
        img = _photo(max(h, 4), max(w, 4), seed=10 + k, gray=sampling == "gray")[:h, :w]
        if sampling in ("4:2:0", "gray"):
            images.write_image(str(tmp_path / "port.jpg"), img)
            imageio.imwrite(str(tmp_path / "imageio.jpg"), img)
            port = (tmp_path / "port.jpg").read_bytes()
            assert port == (tmp_path / "imageio.jpg").read_bytes(), (h, w)
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(port))),
                                          imageio.imread(str(tmp_path / "imageio.jpg")))
        for quality in (50, 75, 95):
            buf = io.BytesIO()
            kwargs = {} if img.ndim == 2 else {"subsampling": PIL_SAMPLING[sampling]}
            Image.fromarray(img).save(buf, format="JPEG", quality=quality, **kwargs)
            name = "4:2:0" if sampling == "gray" else sampling
            assert jpeg.encode(img, quality, name) == buf.getvalue(), (h, w, quality)
            assert codec.encode_jpeg(img, quality, name) == buf.getvalue(), (h, w, quality)


def test_native_jpeg_equals_plain():
    """Random images (the worst case for the entropy coder) at odd sizes in
    each sampling, encoded and decoded by both codecs: the same bytes and
    the same samples."""
    rng = np.random.default_rng(3)
    for h, w in [(1, 1), (7, 9), (16, 16), (17, 33), (40, 48)]:
        for gray in (False, True):
            img = rng.integers(0, 256, (h, w) if gray else (h, w, 3)).astype(np.uint8)
            for sampling in ("4:2:0",) if gray else jpeg.SUBSAMPLING:
                for quality in (30, 95):
                    data = jpeg.encode(img, quality, sampling)
                    assert codec.encode_jpeg(img, quality, sampling) == data
                    np.testing.assert_array_equal(codec.decode_jpeg(data), jpeg.decode(data))
                    assert codec.jpeg_shape(data) == (h, w, 1 if gray else 3)


@pytest.mark.parametrize("kind", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_native_png_unfilter_equals_plain(kind):
    """Every filter type, at 1-8 bytes a pixel, rows of the one type and
    rows that mix all five: the same bytes as the plain `_unfilter`."""
    rng = np.random.default_rng(kind)
    for bpp in (1, 2, 3, 4, 6, 8):
        H, stride = 9, 7 * bpp
        raw = rng.integers(0, 256, (H, stride + 1)).astype(np.uint8)
        for rows in (np.full(H, kind), (np.arange(H) + kind) % 5):
            raw[:, 0] = rows
            np.testing.assert_array_equal(codec.png_unfilter(raw.reshape(-1), H, stride, bpp),
                                          images._unfilter(raw.reshape(-1), H, stride, bpp))
    raw[3, 0] = 5
    with pytest.raises(ValueError, match="unknown PNG filter type 5"):
        codec.png_unfilter(raw.reshape(-1), H, stride, bpp)
    with pytest.raises(ValueError, match="unknown PNG filter type 5"):
        images._unfilter(raw.reshape(-1), H, stride, bpp)


def _patched(data, marker, offset, value):
    """`data` with the byte `offset` after the first `marker` set to `value`."""
    i = data.index(marker) + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def _unsupported():
    img = _photo(16, 24, seed=7)
    ok, progressive = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    ok, s440 = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    base = jpeg.encode(img)
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 1])
    return {
        "progressive (SOF2)": progressive.tobytes(),
        "arithmetic-coded sequential (SOF9)": _patched(base, b"\xff\xc0", 1, 0xC9),
        "lossless (SOF3)": _patched(base, b"\xff\xc0", 1, 0xC3),
        "12-bit samples": _patched(base, b"\xff\xc0", 4, 12),
        "4 components (CMYK or YCCK)": buf.getvalue(),
        "Adobe APP14 colour transform": base[:2] + adobe + base[2:],
        "chroma sampling 1x2, 1x1, 1x1": s440.tobytes(),
        "not a JPEG file": b"\x89PNG\r\n\x1a\n",
    }


@pytest.mark.parametrize("kind", list(_unsupported()))
def test_unsupported_jpegs_raise_naming_their_kind(kind):
    data = _unsupported()[kind]
    for decode in (jpeg.decode, codec.decode_jpeg):
        with pytest.raises(ValueError, match=kind.replace("(", r"\(").replace(")", r"\)")):
            decode(data)


def test_native_library_builds_beside_pointcloud(tmp_path, monkeypatch):
    """Built by g++ into the build dir at first use; without a compiler the
    codec raises, naming it, and `has_native` says False."""
    assert native.has_native()
    assert native.load("jpeg").native_codec_abi_version() == 1
    assert native.build("jpeg").parent == native.BUILD_DIR
    assert native.build("jpeg").name.startswith("jpeg-")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_target", lambda name: tmp_path / "_build" / f"{name}.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"jpeg\.cpp with g\+\+"):
        codec.decode_jpeg(jpeg.encode(np.zeros((8, 8), np.uint8)))
    assert not native.has_native()
