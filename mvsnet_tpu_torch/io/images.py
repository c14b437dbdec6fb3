"""Image and depth-PNG IO (a copy of mvsnet_tpu/io/images.py; reference:
mvs_cluster.py:72-89, mvs_data_generation/utils.py:197-219,
preprocess.py:182-270).

`imageio` is imported inside `_imread` and `_imwrite`, never with the
module: a machine without it (the card machine has no image codec) can
still import the data plane and feed it decoded arrays.
"""

from __future__ import annotations

import numpy as np

from mvsnet_tpu_torch.io.filesystem import is_remote, open_file


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError:
        try:
            import imageio
        except ImportError:
            raise ImportError("reading and writing images needs the 'imageio' package, "
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


def load_image(path):
    """Load an RGB image as uint8 (H, W, 3)."""
    img = np.asarray(_imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def load_depth_png(path):
    """Load a uint16 depth PNG (millimeters) (reference: mvs_cluster.py:78-89)."""
    return np.asarray(_imread(path)).astype(np.uint16)


def write_depth_png(path, depth) -> None:
    """Write depth (mm) clipped to uint16 (reference: preprocess.py:253-260)."""
    depth = np.clip(np.asarray(depth), 0, 65535).astype(np.uint16)
    _imwrite(path, depth)


def write_confidence_png(path, prob) -> None:
    """Probability [0,1] -> uint16 PNG (reference: preprocess.py:262-270)."""
    img = np.clip(np.asarray(prob) * 65535.0, 0, 65535).astype(np.uint16)
    _imwrite(path, img)


def write_image(path, image) -> None:
    _imwrite(path, np.asarray(image).astype(np.uint8))


def write_inverse_depth_png(path, depth, exp: float = 2.0) -> None:
    """Brightness-inverted depth visualization (reference: preprocess.py:182-196)."""
    max_int = 65535
    img = np.asarray(depth, dtype=np.float64)
    img = img - img.min()
    peak = img.max()
    if peak > 0:
        img = img * (max_int / peak)
    inv = np.power((max_int - img) / max_int, exp) * max_int
    _imwrite(path, np.clip(inv, 0, max_int).astype(np.uint16))
