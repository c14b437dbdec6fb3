"""Host-side image/camera/depth transforms in numpy (counterpart of
mvsnet_tpu/data/transforms.py; reference: mvs_data_generation/utils.py).

The JAX package resizes with `cv2.resize`. The port has no cv2 (the card
machine lacks it), so `scale_image` computes what `cv2.resize(image, None,
fx=s, fy=s, interpolation=...)` computes, in numpy:
  * the output size is round(n * s), halves to even;
  * INTER_LINEAR on uint8: cv2's fixed-point path. Per output, the source
    index floor(f) and weights round((1 - f) * 2048), round(f * 2048) with
    f = (d + 0.5) / s - 0.5 in float32; along x an f below 0 or past the
    last pixel is clamped to that pixel (weight 2048, 0); along y the
    weights stay and the row index is clamped. The horizontal pass sums in
    integers; the vertical pass is ((b0 (S0 >> 4)) >> 16) + ((b1 (S1 >> 4))
    >> 16), plus 2, >> 2, as cv2's vector code has it. Bit-equal to
    cv2.resize at every scale tested, up- and downscales;
  * INTER_LINEAR with both scales exactly 1/2 is cv2's 2x2 box average
    (cv2 switches to INTER_AREA there): (sum + 2) >> 2 for uint8, rounded
    half to even for uint16, times 0.25 for float; even sizes only;
  * INTER_LINEAR on other dtypes: the same weights in float32, two taps
    along x then along y, rounded half to even into integer dtypes. This
    is not cv2's arithmetic for these dtypes, which is not known here: at
    scales whose weights are not dyadic (0.75, 1.5, ...) uint16 differs
    from cv2 5.0 by up to 2 levels and float32 by up to 2e-4 of a
    unit-variance input; at 1/4 and 2/3 uint16 is bit-equal. The data
    plane never resizes such inputs linearly: it resizes uint8 images and,
    by INTER_NEAREST, depth maps;
  * INTER_NEAREST: src[min(floor(i * (1 / s)), n - 1)], bit-equal.
As with cv2, a single-channel image (H, W, 1) comes back as (h, w).
"""

from __future__ import annotations

import math

import numpy as np

_COEF_BITS = 11          # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def center_image(img):
    """Per-image, per-channel mean/var normalization
    (reference: mvs_data_generation/utils.py:33-38)."""
    img = img.astype(np.float32)
    var = np.var(img, axis=(0, 1), keepdims=True)
    mean = np.mean(img, axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-8)


def center_images(images):
    return [center_image(im) for im in images]


def scale_camera(cam, scale: float = 1.0):
    """Scale fx, fy, px, py (reference: utils.py:64-73)."""
    new_cam = np.copy(cam)
    new_cam[1][0][0] = cam[1][0][0] * scale
    new_cam[1][1][1] = cam[1][1][1] * scale
    new_cam[1][0][2] = cam[1][0][2] * scale
    new_cam[1][1][2] = cam[1][1][2] * scale
    return new_cam


def _out_size(n: int, s: float) -> int:
    return int(np.rint(n * s))


def _linear_taps(n_in: int, n_out: int, s: float, clamp: bool):
    """Source index and float32 weights (1 - f, f) of each output."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / s) - 0.5).astype(np.float32)
    idx = np.floor(f).astype(np.int64)
    f = f - idx.astype(np.float32)
    if clamp:
        for edge, at in ((idx < 0, 0), (idx >= n_in - 1, n_in - 1)):
            f[edge], idx[edge] = 0, at
    return idx, np.float32(1) - f, f


def _linear(image, s: float):
    H, W = image.shape[:2]
    xs, ax0, ax1 = _linear_taps(W, _out_size(W, s), s, clamp=True)
    ys, by0, by1 = _linear_taps(H, _out_size(H, s), s, clamp=False)
    xs1 = np.minimum(xs + 1, W - 1)
    y0, y1 = np.clip(ys, 0, H - 1), np.clip(ys + 1, 0, H - 1)
    channels = (1,) * (image.ndim - 2)

    def along_x(w):
        return w.reshape((1, -1) + channels)

    def along_y(w):
        return w.reshape((-1, 1) + channels)
    if image.dtype == np.uint8:
        def fixed(w):
            return np.rint(w * _COEF_SCALE).astype(np.int64)
        src = image.astype(np.int64)
        rows = src[:, xs] * along_x(fixed(ax0)) + src[:, xs1] * along_x(fixed(ax1))
        b0, b1 = along_y(fixed(by0)), along_y(fixed(by1))
        out = (((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16)
        return ((out + 2) >> 2).clip(0, 255).astype(np.uint8)
    src = image.astype(np.float32)
    rows = src[:, xs] * along_x(ax0) + src[:, xs1] * along_x(ax1)
    out = rows[y0] * along_y(by0) + rows[y1] * along_y(by1)
    return _cast(out, image.dtype)


def _box2(image):
    """cv2's INTER_AREA fast path at scale 1/2: the mean of each 2x2 box."""
    H, W = image.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"a linear resize by 1/2 takes even sizes, got {H}x{W}")
    h, w = H // 2, W // 2
    quads = [image[i:2 * h:2, j:2 * w:2] for i in (0, 1) for j in (0, 1)]
    if image.dtype == np.uint8:
        total = sum(q.astype(np.int64) for q in quads)
        return ((total + 2) >> 2).astype(np.uint8)
    if np.issubdtype(image.dtype, np.integer):
        return _cast(sum(q.astype(np.int64) for q in quads) / 4.0, image.dtype)
    return ((quads[0] + quads[1] + quads[2] + quads[3]) * image.dtype.type(0.25)).astype(image.dtype)


def _cast(values, dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(values), info.min, info.max).astype(dtype)
    return values.astype(dtype)


def _nearest(image, s: float):
    H, W = image.shape[:2]
    inv = 1.0 / s
    ys = np.minimum(np.floor(np.arange(_out_size(H, s)) * inv).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(_out_size(W, s)) * inv).astype(np.int64), W - 1)
    return image[ys][:, xs]


def resize_nearest(image, width: int, height: int):
    """`cv2.resize(image, (width, height), interpolation=cv2.INTER_NEAREST)`
    in numpy: cv2's taps floor(x * (1 / (width / W))), clamped to the image."""
    image = np.asarray(image)
    H, W = image.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / H))).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / W))).astype(np.int64), W - 1)
    return image[ys][:, xs]


def scale_image(image, scale: float = 1.0, interpolation: str = "linear"):
    """`cv2.resize(image, None, fx=scale, fy=scale, interpolation=...)` in
    numpy (reference: utils.py:83-88); see the module docstring."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    H, W = image.shape[:2]
    if (_out_size(H, scale), _out_size(W, scale)) == (H, W):
        return image.copy()
    if interpolation != "linear":
        return _nearest(image, scale)
    if 1.0 / scale == 2.0:
        return _box2(image)
    return _linear(image, scale)


def scale_mvs_input(images, cams, depth_image=None, scale: float = 1.0):
    """Scale every view's image + intrinsics (reference: utils.py:107-118)."""
    images = [scale_image(im, scale=scale) for im in images]
    cams = [scale_camera(c, scale=scale) for c in cams]
    if depth_image is None:
        return images, cams
    depth_image = scale_image(depth_image, scale=scale, interpolation="nearest")
    return images, cams, depth_image


def crop_mvs_input(images, cams, width: int, height: int, base_image_size: int,
                   depth_image=None):
    """Center-crop to <= (width, height) and to a multiple of
    base_image_size, shifting the principal point (reference: utils.py:121-153)."""
    images = list(images)
    cams = [np.copy(c) for c in cams]
    start_h = start_w = finish_h = finish_w = 0
    for view in range(len(images)):
        h, w = images[view].shape[0:2]
        new_h = height if h > height else int(math.ceil(h / base_image_size) * base_image_size)
        new_w = width if w > width else int(math.ceil(w / base_image_size) * base_image_size)
        start_h = int(math.ceil((h - new_h) / 2))
        start_w = int(math.ceil((w - new_w) / 2))
        finish_h = start_h + new_h
        finish_w = start_w + new_w
        images[view] = images[view][start_h:finish_h, start_w:finish_w]
        cams[view][1][0][2] -= start_w
        cams[view][1][1][2] -= start_h

    if depth_image is not None:
        depth_image = depth_image[start_h:finish_h, start_w:finish_w]
        return images, cams, depth_image
    return images, cams


def mask_depth_image(depth_image, min_depth: float, max_depth: float):
    """Zero out-of-range depths, add channel dim (reference: utils.py:156-163)."""
    depth = np.asarray(depth_image).astype(np.float32)
    # cv2.THRESH_TOZERO / THRESH_TOZERO_INV boundary semantics:
    # keep min < d <= max, zero the rest.
    depth = np.where(depth <= min_depth, 0.0, depth)
    depth = np.where(depth > max_depth, 0.0, depth)
    if depth.ndim == 2:
        depth = depth[..., None]
    return depth


def scale_and_reshape_depth(depth_image, output_scale: float):
    """(reference: utils.py:91-99)"""
    depth = scale_image(np.copy(depth_image), scale=output_scale, interpolation="nearest")
    return depth.reshape(depth.shape[0], depth.shape[1], 1)


def reshape_depth(depth):
    return np.asarray(depth).reshape(depth.shape[0], depth.shape[1], 1)


def flip_cams(cams, depth_num: int):
    """Reverse the depth sweep for R-MVSNet bidirectional training
    (reference: utils.py:166-171): start += (D-1)*interval; interval *= -1.
    Applied to the reference cam (index 0)."""
    cams = np.copy(cams)
    cams[0][1, 3, 0] = cams[0][1, 3, 0] + (depth_num - 1) * cams[0][1, 3, 1]
    cams[0][1, 3, 1] = -cams[0][1, 3, 1]
    return cams
