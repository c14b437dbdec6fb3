"""Plane-sweep homography geometry (counterpart of mvsnet_tpu/ops/geometry.py).

Cam tensor convention (reference: mvs_cluster.py:91-111):
  cam[0]           : 4x4 world->camera extrinsic [R|t]
  cam[1][:3, :3]   : 3x3 intrinsic K
  cam[1][3]        : [depth_start, depth_interval, depth_num, depth_end]

The homography from the reference image to a source image at fronto-parallel
depth d:  H(d) = K_r R_r (I - c_rel n0^T / d) R_l^T K_l^{-1}.
Always float32: the projected coordinates need sub-pixel precision.

CasMVSNet's cascade projects each pixel at its own depths instead:
`pixel_projections` gives each source view's [M | b] with q = d M p + b,
`cascade_planes` each stage's plane depths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def depth_values(depth_start, depth_interval, depth_num: int, *,
                 dtype=torch.float32) -> torch.Tensor:
    """start + i * interval for i in [0, D): (D,) or (B, D), in `dtype`."""
    depth_start = torch.as_tensor(depth_start, dtype=dtype)
    depth_interval = torch.as_tensor(depth_interval, dtype=dtype, device=depth_start.device)
    i = torch.arange(depth_num, dtype=dtype, device=depth_start.device)
    if depth_start.ndim == 0:
        return depth_start + i * depth_interval
    return depth_start[:, None] + i[None, :] * depth_interval[:, None]


def inv_depth_values(depth_start, depth_end, depth_num: int, *,
                     dtype=torch.float32) -> torch.Tensor:
    """1 / linspace(1/start, 1/end, D) in `dtype` (reference:
    homography_warping.py:74-77)."""
    depth_start = torch.as_tensor(depth_start, dtype=dtype)
    depth_end = torch.as_tensor(depth_end, dtype=dtype, device=depth_start.device)
    t = torch.linspace(0.0, 1.0, depth_num, dtype=dtype, device=depth_start.device)
    if depth_start.ndim == 0:
        inv = (1.0 / depth_start) * (1 - t) + (1.0 / depth_end) * t
        return 1.0 / inv
    inv = ((1.0 / depth_start)[:, None] * (1 - t)[None, :]
           + (1.0 / depth_end)[:, None] * t[None, :])
    return 1.0 / inv


def _homographies_from_depths(left_cam, right_cam, depth) -> torch.Tensor:
    """(B, 2, 4, 4) ref cam, (B, 2, 4, 4) source cam, (B, D) depths ->
    (B, D, 3, 3) homographies on image coordinates (pixel centres at +0.5)."""
    left_cam = _f32(left_cam, depth.device)
    right_cam = _f32(right_cam, depth.device)
    R_l = left_cam[:, 0, :3, :3]
    R_r = right_cam[:, 0, :3, :3]
    t_l = left_cam[:, 0, :3, 3:4]
    t_r = right_cam[:, 0, :3, 3:4]
    K_l = left_cam[:, 1, :3, :3]
    K_r = right_cam[:, 1, :3, :3]

    # inv_ex: the same inverse without the error check, which on the card
    # would wait for the device; an intrinsic matrix is always invertible
    K_l_inv = torch.linalg.inv_ex(K_l).inverse
    R_l_T = R_l.transpose(-1, -2)
    c_l = -R_l_T @ t_l
    c_r = -R_r.transpose(-1, -2) @ t_r
    c_rel = c_r - c_l
    fronto = R_l[:, 2:3, :]

    outer = c_rel @ fronto                                        # (B,3,3)
    eye = torch.eye(3, dtype=torch.float32, device=depth.device)
    middle = eye[None, None] - outer[:, None] / depth[:, :, None, None]
    left_part = (R_l_T @ K_l_inv)[:, None]
    right_part = (K_r @ R_r)[:, None]
    return right_part @ (middle @ left_part)


def get_homographies(left_cam, right_cam, depth_num: int, depth_start,
                     depth_interval) -> torch.Tensor:
    """Linear-depth homographies, (B, D, 3, 3)."""
    B = left_cam.shape[0]
    device = torch.as_tensor(left_cam).device
    depth_start = _f32(depth_start, device).expand(B)
    depth_interval = _f32(depth_interval, device).expand(B)
    depth = depth_values(depth_start, depth_interval, depth_num)
    return _homographies_from_depths(left_cam, right_cam, depth)


def get_homographies_inv_depth(left_cam, right_cam, depth_num: int,
                               depth_start, depth_end) -> torch.Tensor:
    """Inverse-depth homographies, per batch element, (B, D, 3, 3)."""
    B = left_cam.shape[0]
    device = torch.as_tensor(left_cam).device
    depth_start = _f32(depth_start, device).expand(B)
    depth_end = _f32(depth_end, device).expand(B)
    depth = inv_depth_values(depth_start, depth_end, depth_num)
    return _homographies_from_depths(left_cam, right_cam, depth)


def homographies_for_views(cams, depth_num: int, depth_start,
                           depth_interval=None, depth_end=None,
                           inverse_depth: bool = False) -> torch.Tensor:
    """(B, V, 2, 4, 4) cams, view 0 the reference -> (V-1, B, D, 3, 3)."""
    ref_cam = cams[:, 0]
    out = []
    for v in range(1, cams.shape[1]):
        if inverse_depth:
            out.append(get_homographies_inv_depth(ref_cam, cams[:, v], depth_num,
                                                  depth_start, depth_end))
        else:
            out.append(get_homographies(ref_cam, cams[:, v], depth_num,
                                        depth_start, depth_interval))
    return torch.stack(out, dim=0)


def scale_camera(cam, scale: float) -> torch.Tensor:
    """Cam tensor(s) (..., 2, 4, 4) with fx, fy, px, py scaled for an image
    resized by `scale` (geometry.py:144; reference:
    mvs_data_generation/utils.py:64-73)."""
    cam = torch.as_tensor(cam)
    scale_mat = torch.tensor([[scale, 1.0, scale], [1.0, scale, scale], [1.0, 1.0, 1.0]],
                             dtype=cam.dtype, device=cam.device)
    out = cam.clone()
    out[..., 1, :3, :3] = cam[..., 1, :3, :3] * scale_mat
    return out


def pixel_projections(cams, scale: float = 1.0) -> torch.Tensor:
    """(B, V, 2, 4, 4) cams, view 0 the reference, their intrinsics' top two
    rows times `scale` -> (V-1, B, 3, 4) float32 [M_v | b_v], the top rows
    of P_v P_ref^-1 with P = [[K R, K t], [0, 1]]: a reference pixel p
    (homogeneous, centres at +0.5) at depth d lands at d M_v p + b_v in
    view v, M_v = K_v R_v R_ref^T K_ref^-1, b_v = K_v (t_v - R_v R_ref^T t_ref)."""
    cams = _f32(cams)
    K = cams[:, :, 1, :3, :3].clone()
    K[:, :, :2] *= scale
    R, t = cams[:, :, 0, :3, :3], cams[:, :, 0, :3, 3:4]
    # inv_ex: no error check, which on the card would wait for the device
    left = R[:, 0].transpose(-1, -2) @ torch.linalg.inv_ex(K[:, 0]).inverse
    rel = R[:, 0].transpose(-1, -2) @ t[:, 0]
    out = []
    for v in range(1, cams.shape[1]):
        KR = K[:, v] @ R[:, v]
        out.append(torch.cat([KR @ left, K[:, v] @ t[:, v] - KR @ rel], dim=-1))
    return torch.stack(out, dim=0)


def cascade_planes(depth, num: int, ratio: float, depth_min, depth_max, max_d: int,
                   size) -> torch.Tensor:
    """A cascade stage's plane depths (CasMVSNet, cas_mvsnet.py /
    module.py's `get_depth_range_samples`), float32. `depth` None: `num`
    planes uniform over [depth_min, depth_max] (B,), the same at every
    pixel, (B, num). Else centred on the stage before's depth (B, h', w')
    resized bilinearly (align_corners=False) to `size` (h, w):
    d_k = c - num/2 ratio delta + k num ratio delta / (num - 1), delta =
    (depth_max - depth_min) / max_d, (B, num, h, w). The published model
    resizes the depth to the images' size, forms the planes there and
    resizes them trilinearly to the stage's; at the stage's size, which is
    the images' or half of it, that is this bilinear resize to `size`
    (the mean of two bilinear samples a quarter of a pixel apart is the
    sample half way), up to rounding."""
    depth_min = _f32(depth_min)
    depth_max = _f32(depth_max, depth_min.device)
    k = torch.arange(num, dtype=torch.float32, device=depth_min.device)
    if depth is None:
        return depth_min[:, None] + k[None] * ((depth_max - depth_min) / (num - 1))[:, None]
    center = F.interpolate(depth[:, None], size=tuple(size), mode="bilinear",
                           align_corners=False)[:, 0]
    step = (ratio * (depth_max - depth_min) / max_d)[:, None, None]
    return ((center - num / 2 * step)[:, None]
            + k[None, :, None, None] * (num * step / (num - 1))[:, None])
