"""The port's data plane (`mvsnet_tpu_torch/{data,io,utils}`) against the JAX
package's on the same files: cv2's resize computed in numpy, the
`ClusterGenerator` in every mode (every array bit-equal, the same order),
its cache and shards, the prefetching loader, camera and image IO, and the
in-memory synthetic scenes.

`scale_image` is held bit-equal to `cv2.resize` wherever its arithmetic is
cv2's: uint8 INTER_LINEAR at every scale (fixed point), INTER_NEAREST for
every dtype, the 2x2 box of scale 1/2. uint16 INTER_LINEAR is bit-equal
where the weights are dyadic (1/4, 2/3) and within 2 levels elsewhere
(0.75, 1.5): the float path of cv2 5.0 is not known exactly, and the data
plane never takes it (depth maps resize by INTER_NEAREST).
"""

import json
import os
import sys
from collections import Counter

import cv2
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synthetic_session import make_dataset, make_session  # noqa: E402

from mvsnet_tpu.data import ClusterGenerator as JaxGenerator  # noqa: E402
from mvsnet_tpu.data import transforms as jax_T  # noqa: E402
from mvsnet_tpu.io import cams as jax_cams  # noqa: E402
from mvsnet_tpu_torch.data import ClusterGenerator, PrefetchingLoader, batch_iterator  # noqa: E402
from mvsnet_tpu_torch.data import synthetic  # noqa: E402
from mvsnet_tpu_torch.data import transforms as T  # noqa: E402
from mvsnet_tpu_torch.io import cams, filesystem, images  # noqa: E402
from mvsnet_tpu_torch.utils.paths import ckpt_dir  # noqa: E402

SCALES = [0.25, 0.5, 2 / 3, 0.75, 1.0, 1.5]
CV2 = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.uniform(1500, 2500, shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"{s:.3f}")
@pytest.mark.parametrize("kind", ["uint8 rgb linear", "uint8 rgb nearest",
                                  "uint8 gray linear", "uint16 depth nearest",
                                  "float32 depth (h,w,1) nearest"])
def test_scale_image_is_cv2_resize(kind, scale):
    dtype = {"uint8": np.uint8, "uint16": np.uint16, "float32": np.float32}[kind.split()[0]]
    shape = {"rgb": (96, 128, 3), "gray": (96, 128), "depth": (96, 128)}[kind.split()[1]]
    if "(h,w,1)" in kind:
        shape = (96, 128, 1)
    interp = kind.split()[-1]
    img = _image(shape, dtype)
    got = T.scale_image(img, scale, interp)
    want = cv2.resize(img, None, fx=scale, fy=scale, interpolation=CV2[interp])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"{s:.3f}")
def test_scale_image_uint16_linear(scale):
    """Bit-equal at dyadic weights; elsewhere the stated residual of 2 levels."""
    img = _image((96, 128), np.uint16, seed=1)
    got = T.scale_image(img, scale).astype(np.int64)
    want = cv2.resize(img, None, fx=scale, fy=scale).astype(np.int64)
    assert got.shape == want.shape
    residual = 0 if scale in (0.25, 0.5, 2 / 3, 1.0) else 2
    assert np.abs(got - want).max() <= residual


def test_scale_image_uint8_odd_sizes_and_half_box():
    """Tails of the vector loops and clamped borders: odd sizes, up and
    down; scale 1/2 is cv2's box (the INTER_AREA switch)."""
    for shape in [(75, 101, 3), (97, 131), (480, 640, 3)]:
        img = _image(shape, np.uint8, seed=2)
        for s in (0.3, 2 / 3, 1.25, 1.5):
            np.testing.assert_array_equal(T.scale_image(img, s), cv2.resize(img, None, fx=s, fy=s))
    img = _image((64, 64, 3), np.uint8, seed=3)
    box = ((img[0::2, 0::2].astype(int) + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]
            + 2) >> 2).astype(np.uint8)
    np.testing.assert_array_equal(T.scale_image(img, 0.5), box)
    np.testing.assert_array_equal(box, cv2.resize(img, None, fx=0.5, fy=0.5))


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    imgs = [_image((96, 96, 3), np.uint8, seed=i) for i in range(3)]
    cam_list = [jax_cams.cam_from_camera_json(
        {"intrinsics": {"fx": 115.2, "fy": 115.2, "px": 48.0, "py": 48.0},
         "pose": {"matrix": {f"{r},{c}": float(r == c) + 0.01 * i for r in range(4)
                             for c in range(4)}}}, 1500, 2500, 8) for i in range(3)]
    depth = rng.uniform(1400, 2600, (96, 96)).astype(np.float32)
    for name, args in [("scale_mvs_input", (imgs, cam_list, depth, 2 / 3)),
                       ("crop_mvs_input", (imgs, cam_list, 64, 48, 32, depth)),
                       ("mask_depth_image", (depth, 1500.0, 2500.0)),
                       ("scale_and_reshape_depth", (depth[..., None], 0.25)),
                       ("center_image", (imgs[0],)), ("flip_cams", (np.stack(cam_list), 8)),
                       ("scale_camera", (cam_list[0], 0.25))]:
        got, want = getattr(T, name)(*args), getattr(jax_T, name)(*args)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            for a, b in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_dataset(root, n_sessions=2, split="train", n_images=4)
    make_dataset(root, n_sessions=1, split="val", n_images=3)
    make_dataset(root, n_sessions=1, split="test", n_images=3)
    make_session(os.path.join(root, "inference"), n_images=4)
    return root


GEN = dict(view_num=3, image_width=64, image_height=64, depth_num=8, base_image_size=32)


def _same_samples(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("mode,flip", [("train", False), ("train", True), ("val", False),
                                       ("test", False), ("inference", False)])
def test_generator_matches_jax(dataset, mode, flip):
    """Every array of every sample bit-equal, in iterate_once's order."""
    root = os.path.join(dataset, "inference") if mode == "inference" else dataset
    kw = dict(GEN, mode=mode, flip_cams=flip, clear_cache=True, seed=3)
    _same_samples(list(ClusterGenerator(root, **kw).iterate_once()),
                  list(JaxGenerator(root, **kw).iterate_once()))


def test_generator_cache_and_shards(dataset):
    """The clusters.pickle cache one package writes, the other reads; two
    shards split the clusters as JAX's do."""
    kw = dict(GEN, mode="train", flip_cams=False)
    first = JaxGenerator(dataset, clear_cache=True, **kw)          # writes the cache
    cache = os.path.join(dataset, "train", "clusters.pickle")
    assert os.path.exists(cache)
    cached = ClusterGenerator(dataset, **kw)
    assert [c.to_json() for c in cached.clusters] == [c.to_json() for c in first.clusters]
    _same_samples(list(cached.iterate_once()), list(first.iterate_once()))
    shards = [ClusterGenerator(dataset, shard_index=i, shard_count=2, **kw) for i in (0, 1)]
    for i, shard in enumerate(shards):
        want = JaxGenerator(dataset, shard_index=i, shard_count=2, **kw)
        assert [c.to_json() for c in shard.clusters] == [c.to_json() for c in want.clusters]
    names = [(c.session_dir, c.ref_index) for s in shards for c in s.clusters]
    assert sorted(names) == sorted((c.session_dir, c.ref_index) for c in first.clusters)


def test_prefetching_loader(dataset):
    """workers=1 keeps iterate_once's order; a pool gives the same batches
    as a multiset (completion order)."""
    kw = dict(GEN, mode="train", flip_cams=True)
    want = list(batch_iterator(ClusterGenerator(dataset, **kw).iterate_once(), 2))

    def key(batch):
        return tuple(np.ascontiguousarray(a).tobytes() for a in batch)

    serial = list(PrefetchingLoader(lambda: ClusterGenerator(dataset, **kw), batch_size=2,
                                    workers=1, epochs=1))
    assert [key(b) for b in serial] == [key(b) for b in want]
    samples = list(ClusterGenerator(dataset, **kw).iterate_once())
    pooled = list(PrefetchingLoader(lambda: ClusterGenerator(dataset, **kw), batch_size=1,
                                    workers=3, epochs=1))
    assert Counter(key(b) for b in pooled) == Counter(
        key(tuple(np.asarray(a)[None] for a in s)) for s in samples)


def test_cams_io_matches_jax(tmp_path):
    session = os.path.join(make_session(str(tmp_path / "s"), n_images=2), "cameras", "0.json")
    got = cams.load_camera_json(session, 1500, 2500, 16, 1.06)
    want = jax_cams.load_camera_json(session, 1500, 2500, 16, 1.06)
    np.testing.assert_array_equal(got, want)
    assert tuple(got[0, :2, 3]) == pytest.approx((-40.0, -20.0))     # meters -> mm
    path = str(tmp_path / "cam.txt")
    cams.write_cam_txt(path, got)
    for n_words in (None, 8):
        np.testing.assert_array_equal(cams.load_cam_txt(path, 1.5, n_words),
                                      jax_cams.load_cam_txt(path, 1.5, n_words))
    np.testing.assert_array_equal(cams.projection_matrix(got), jax_cams.projection_matrix(got))


def test_images_io_and_lazy_codec(tmp_path, monkeypatch):
    from mvsnet_tpu.io import images as jax_images

    depth = np.random.default_rng(5).uniform(0, 3000, (16, 20))
    for name in ("write_depth_png", "write_confidence_png", "write_inverse_depth_png"):
        arg = depth / 3000 if name == "write_confidence_png" else depth
        getattr(images, name)(str(tmp_path / f"{name}.png"), arg)
        getattr(jax_images, name)(str(tmp_path / f"{name}_jax.png"), arg)
        np.testing.assert_array_equal(images.load_depth_png(str(tmp_path / f"{name}.png")),
                                      jax_images.load_depth_png(str(tmp_path / f"{name}_jax.png")))
    rgb = _image((8, 8, 3), np.uint8)
    images.write_image(str(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(images.load_image(str(tmp_path / "rgb.png")), rgb)
    # without imageio: importable, and a read names the missing package
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        images.load_image(str(tmp_path / "rgb.png"))


def _filtered_png(image, kind):
    """A PNG of `image` whose every row carries PNG filter `kind` (0-4),
    filtered here byte by byte as the PNG spec (section 9) defines it."""
    import struct
    import zlib

    samples = np.ascontiguousarray(image, ">u2" if image.dtype == np.uint16 else np.uint8)
    H = image.shape[0]
    rows = samples.reshape(H, -1).view(np.uint8).astype(np.int64)
    bpp = image.itemsize * (1 if image.ndim == 2 else image.shape[2])
    out = []
    for y in range(H):
        cur, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[y])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][kind]
        out.append(np.concatenate([[kind], (cur - pred) % 256]).astype(np.uint8))
    color = {1: 0, 3: 2, 4: 6}[1 if image.ndim == 2 else image.shape[2]]

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    header = struct.pack(">IIBBBBB", image.shape[1], H, 8 * image.itemsize, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes())) + chunk(b"IEND", b""))


def _cv2_decode(data):
    """cv2's PNG decode, as stored (RGB(A) order; imageio reads 16-bit
    colour PNGs as 8-bit)."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


@pytest.mark.parametrize("dtype,channels", [(np.uint16, 1), (np.uint8, 3), (np.uint8, 4),
                                            (np.uint16, 3)])
def test_png_codec_matches_imageio(dtype, channels):
    """The port's PNG encoder and decoder (`io/images.py`, no codec
    needed) against cv2's and imageio's: its encoder's bytes decode to the
    array; the decoder reads every filter type (0-4), and cv2's adaptively
    filtered PNGs, as they do, bit for bit."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(11)
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    top = np.iinfo(dtype).max
    image = rng.integers(0, top, shape, endpoint=True).astype(dtype)
    ramp = np.linspace(0, top // 2, 17).astype(dtype)
    image[4:9] = ramp if channels == 1 else ramp[:, None]
    readers = [_cv2_decode]
    if dtype == np.uint8 or channels == 1:
        readers.append(lambda data: imageio.imread(data, format=".png"))
    encoded = images.encode_png(image)
    np.testing.assert_array_equal(images.decode_png(encoded), image)
    for read in readers:
        np.testing.assert_array_equal(read(encoded), image)
    for kind in range(5):
        data = _filtered_png(image, kind)
        np.testing.assert_array_equal(images.decode_png(data), image)
        for read in readers:
            np.testing.assert_array_equal(read(data), image)
    bgr = image if channels == 1 else image[..., [2, 1, 0, 3][:channels]].copy()
    ok, buf = cv2.imencode(".png", bgr)
    assert ok
    np.testing.assert_array_equal(images.decode_png(buf.tobytes()), image)


def test_remote_filesystem_and_paths():
    import fsspec

    fsspec.filesystem("memory").store.clear()
    root = "memory://port_fs"
    path = ckpt_dir(root, "3DCNN", "lite", build=True)
    assert path == "memory://port_fs/3DCNN/lite" and filesystem.isdir(path)
    filesystem.write_bytes(filesystem.join(path, "a.bin"), b"xyz")
    assert filesystem.read_bytes(filesystem.join(path, "a.bin")) == b"xyz"
    assert filesystem.listdir(path) == ["a.bin"]
    assert ckpt_dir("/tmp/m", "GRU", "normal") == os.path.join("/tmp/m", "GRU", "normal")


def test_synthetic_scene_matches_the_session_files(dataset, tmp_path):
    """The in-memory render of a session against the files
    `synthetic_session.make_session` writes: the blur to cv2's within 1e-4,
    cameras and depths bit-equal through the generator, the JPEG-coded
    images within a few gray levels."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 255, (96, 96, 3)).astype(np.float32)
    np.testing.assert_allclose(synthetic.gaussian_blur(tex, 2.0),
                               cv2.GaussianBlur(tex, (0, 0), 2.0), atol=1e-4)
    make_dataset(str(tmp_path), n_sessions=2, split="train", n_images=4)
    kw = dict(GEN, mode="train", flip_cams=False, clear_cache=True)
    files = list(JaxGenerator(str(tmp_path), **kw).iterate_once())
    sessions = [synthetic.render_session(n_images=4, seed=k) for k in range(2)]
    kw.pop("clear_cache")
    memory = list(synthetic.SyntheticGenerator(sessions, **kw).iterate_once())
    assert len(memory) == len(files)
    for (im_m, cams_m, d_m, full_m), (im_f, cams_f, d_f, full_f) in zip(memory, files):
        np.testing.assert_array_equal(cams_m, cams_f)
        np.testing.assert_array_equal(d_m, d_f)
        np.testing.assert_array_equal(full_m, full_f)
        assert np.abs(im_m - im_f).mean() < 0.1             # centered: unit variance
    raw = cv2.imread(os.path.join(str(tmp_path), "train", "session_0", "images", "1.jpg"))
    assert np.abs(raw[..., ::-1].astype(int) - sessions[0]["images"][1]).mean() < 6
    shards = [synthetic.SyntheticGenerator(sessions, shard_index=i, shard_count=2, **kw)
              for i in (0, 1)]
    want = [c.to_json() for c in JaxGenerator(str(tmp_path), **kw).clusters]
    for i, shard in enumerate(shards):
        got = [dict(c.to_json(), session_dir=None) for c in shard.clusters]
        assert got == [dict(c, session_dir=None) for c in want[i::2]]


def test_covisibility_round_trip(tmp_path):
    """`render_session`'s covisibility has the file's layout."""
    session = synthetic.render_session(n_images=3)
    path = make_session(str(tmp_path / "s"), n_images=3)
    with open(os.path.join(path, "covisibility.json")) as f:
        assert json.load(f) == session["covisibility"]
