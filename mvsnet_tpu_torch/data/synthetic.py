"""Synthetic plane scenes rendered in memory, served through the data
plane without files or an image codec.

The scene is the one `tests/synthetic_session.py` writes to disk: a
smooth random texture on a fronto-parallel plane at a known depth (mm),
seen by a small grid of translated cameras with identity rotations. Here
it is rendered with numpy (a separable Gaussian blur with cv2's kernel
size and reflect-101 border in place of `cv2.GaussianBlur`, a bilinear
zero-fill warp in place of `cv2.warpPerspective`) and never JPEG-coded.
`SyntheticGenerator` is a `ClusterGenerator` over such sessions: every
sample goes through the same transforms (rescale, crop, centering, camera
and depth scaling) as a session read from disk. `write_dtu_scan` writes
the scene to disk in the DTU training layout that `tools.convert_dtu`
reads.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from mvsnet_tpu_torch.data.cluster import Cluster
from mvsnet_tpu_torch.data.generator import ClusterGenerator
from mvsnet_tpu_torch.io import images as imio
from mvsnet_tpu_torch.io.cams import cam_from_camera_json, write_cam_txt
from mvsnet_tpu_torch.io.pfm import write_pfm


def _plane_homography(K, t_ref, t_src, depth):
    """H mapping ref pixel -> src pixel for the z=depth fronto plane,
    identity rotations, world->cam translation t (mm)."""
    c_rel = (-np.asarray(t_src, float) + np.asarray(t_ref, float)).reshape(3, 1)
    n = np.array([[0.0, 0.0, 1.0]])
    return K @ (np.eye(3) - (c_rel @ n) / depth) @ np.linalg.inv(K)


def gaussian_blur(image, sigma: float):
    """A separable Gaussian blur of an (H, W, C) float image: cv2's kernel
    size for float input (round(8 sigma + 1), odd) and its default border
    (reflect-101)."""
    k = int(round(sigma * 8 + 1)) | 1
    x = np.arange(k) - k // 2
    taps = np.exp(-x ** 2 / (2 * sigma ** 2))
    taps /= taps.sum()
    out = image.astype(np.float64)
    for axis in (0, 1):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (k // 2, k // 2)
        padded = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        out = sum(t * np.take(padded, np.arange(i, i + n), axis=axis) for i, t in enumerate(taps))
    return out.astype(np.float32)


def warp_bilinear(image, H):
    """out[y, x] = image at H @ (x, y, 1), bilinear, zero outside."""
    h, w = image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.tensordot(H, np.stack([xs, ys, np.ones_like(xs)]), axes=1)
    sx, sy = p[0] / p[2], p[1] / p[2]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    out = np.zeros(image.shape, np.float64)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
            tap = image[yy.clip(0, h - 1), xx.clip(0, w - 1)]
            out += np.where(inside, tap, 0.0) * wy * wx
    return out


def render_session(width: int = 96, height: int = 96, n_images: int = 5,
                   plane_depth_mm: float = 2000.0, min_depth: float = 1500.0,
                   max_depth: float = 2500.0, baseline_mm: float = 40.0,
                   seed: int = 0) -> dict:
    """One session in memory, laid out as `tests/synthetic_session.py`'s
    `make_session` writes it: {"images": [uint8 (H, W, 3)], "cameras":
    [camera.json dicts], "depths": [uint16 (H, W)], "covisibility": {...}}.
    Pose translations are meters, as in camera.json."""
    rng = np.random.default_rng(seed)
    K = np.array([[width * 1.2, 0, width / 2.0], [0, width * 1.2, height / 2.0], [0, 0, 1.0]])
    tex = gaussian_blur(rng.uniform(0, 255, (height, width, 3)).astype(np.float32), 2.0)
    tex = (255 * (tex - tex.min()) / (np.ptp(tex) + 1e-6)).astype(np.uint8)
    translations = [np.array([baseline_mm * ((i % 3) - 1), baseline_mm * ((i // 3) - 0.5), 0.0])
                    for i in range(n_images)]
    session = {"images": [], "cameras": [], "depths": [], "covisibility": {}}
    for i, t in enumerate(translations):
        H = _plane_homography(K, translations[0], t, plane_depth_mm)
        img = warp_bilinear(tex.astype(np.float64), H)
        # make_session writes with cv2 (BGR), and the data plane reads RGB
        session["images"].append(np.clip(np.rint(img[..., ::-1]), 0, 255).astype(np.uint8))
        pose = np.eye(4)
        pose[:3, 3] = t / 1000.0
        session["cameras"].append({
            "intrinsics": {"fx": K[0, 0], "fy": K[1, 1], "px": K[0, 2], "py": K[1, 2]},
            "pose": {"matrix": {f"{r},{c}": float(pose[r, c]) for r in range(4) for c in range(4)}}})
        session["depths"].append(np.full((height, width), plane_depth_mm, np.uint16))
        views = [j for j in range(n_images) if j != i][:4]
        session["covisibility"][str(i)] = {"views": views, "min_depth": min_depth,
                                           "max_depth": max_depth}
    return session


class _MemoryCluster(Cluster):
    """A cluster whose images, depths and cameras come from a rendered
    session instead of its files."""

    def __init__(self, session: dict, *args, **kwargs):
        self.session = session
        super().__init__(*args, **kwargs)

    def load_image(self, index):
        return self.session["images"][index]

    def load_depth(self, index):
        return self.session["depths"][index]

    def load_camera(self, index):
        return cam_from_camera_json(self.session["cameras"][index], self.min_depth,
                                    self.max_depth, self.depth_num, self.interval_scale)


class SyntheticGenerator(ClusterGenerator):
    """`ClusterGenerator` over rendered sessions (`render_session`), in any
    of its modes, with its seeded shuffle and shards."""

    def __init__(self, sessions: Sequence[dict], **kwargs):
        self._sessions = list(sessions)
        kwargs.setdefault("data_dir", "<memory>")
        super().__init__(**kwargs)

    def _set_sessions_dir(self):
        self.sessions_dir = self.data_dir

    def parse_sessions(self):
        clusters = []
        for s, session in enumerate(self._sessions):
            covis = session["covisibility"]
            limit = (len(covis) if self.max_clusters_per_session is None
                     else self.max_clusters_per_session)
            added = 0
            for d, entry in covis.items():
                if (self.include_empty or entry["views"]) and added < limit:
                    clusters.append(_MemoryCluster(
                        session, f"{self.data_dir}/session_{s}", int(d), entry["views"],
                        entry["min_depth"], entry["max_depth"], self.view_num,
                        self.image_width, self.image_height, self.depth_num,
                        self.interval_scale))
                    added += 1
        if self.mode in ("train", "val"):
            random.Random(self.seed).shuffle(clusters)
        if self.shard_count > 1:
            clusters = clusters[self.shard_index::self.shard_count]
        self.clusters = clusters
        return clusters


# convert_dtu scales a DTU camera by 512/1200 (px also by 0.94) and
# dtu_fixer its focal lengths by 1.171875: the inverse puts the rendered
# camera back after both
_DTU_RESCALE = 512.0 / 1200.0
_DTU_FOCAL = 1.171875
# the scan's directory name in DTU's training layout; its plane lies inside
# the depth range `convert_utils.pair_to_covisibility` gives DTU sessions
# (400-1000 mm), its cameras 5 mm apart
DTU_SCAN = "scan1_train"
DTU_PLANE_MM = 700.0
DTU_BASELINE_MM = 5.0


def write_dtu_scan(root: str, width: int = 640, height: int = 512, n_views: int = 49,
                   n_lightings: int = 7, workers: int = 8) -> None:
    """The rendered plane scene as one scan of DTU's training layout under
    `root` (scan `DTU_SCAN`), written by the port's writers: `Cameras/pair.txt` (each view's
    10 nearest views) and `Cameras/<i:08d>_cam.txt` (the camera that
    `tools.convert_dtu` and `tools.dtu_fixer` turn back into the rendered
    one; translations in mm), `Rectified/<scan>/rect_<i+1:03d>_<l>_r5000.png`
    (8-bit RGB; lighting l scales the brightness by 0.7 + 0.1 l) and
    `Depths/<scan>/depth_map_<i:04d>.pfm` (at a quarter of the image size,
    as DTU's are)."""
    session = render_session(width, height, n_images=n_views, plane_depth_mm=DTU_PLANE_MM,
                             baseline_mm=DTU_BASELINE_MM)
    cams_dir = os.path.join(root, "Cameras")
    images_dir = os.path.join(root, "Rectified", DTU_SCAN)
    depths_dir = os.path.join(root, "Depths", DTU_SCAN)
    for d in (cams_dir, images_dir, depths_dir):
        os.makedirs(d, exist_ok=True)
    centers = []
    for i, (camera, depth) in enumerate(zip(session["cameras"], session["depths"])):
        pose = camera["pose"]["matrix"]
        cam = np.zeros((2, 4, 4))
        cam[0] = [[pose[f"{r},{c}"] for c in range(4)] for r in range(4)]
        cam[0, :3, 3] *= 1000.0
        k = camera["intrinsics"]
        cam[1, :3, :3] = [[k["fx"] / (_DTU_RESCALE * _DTU_FOCAL), 0,
                           k["px"] / (_DTU_RESCALE * 0.94)],
                          [0, k["fy"] / (_DTU_RESCALE * _DTU_FOCAL), k["py"] / _DTU_RESCALE],
                          [0, 0, 1]]
        cam[1, 3, :2] = [425.0, 2.5]
        write_cam_txt(os.path.join(cams_dir, f"{i:08d}_cam.txt"), cam)
        write_pfm(os.path.join(depths_dir, f"depth_map_{i:04d}.pfm"),
                  depth[::4, ::4].astype(np.float32))
        centers.append(cam[0, :3, 3])
    centers = np.asarray(centers)
    lines = [str(n_views)]
    for i in range(n_views):
        dist = np.linalg.norm(centers - centers[i], axis=1)
        near = [j for j in np.argsort(dist, kind="stable") if j != i][:10]
        lines += [str(i), f"{len(near)} " + " ".join(f"{j} {1000.0 / dist[j]:.2f}" for j in near)]
    with open(os.path.join(cams_dir, "pair.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    def write(job):
        i, light = job
        image = np.clip(np.rint(session["images"][i] * (0.7 + 0.1 * light)), 0, 255)
        imio.write_png(os.path.join(images_dir, f"rect_{i + 1:03d}_{light}_r5000.png"),
                       image.astype(np.uint8))

    jobs = [(i, light) for i in range(n_views) for light in range(n_lightings)]
    with ThreadPoolExecutor(max(1, workers)) as pool:
        list(pool.map(write, jobs))
