"""Depth-map fusion to point clouds, on the card (counterpart of
mvsnet_tpu/fusion.py).

Replaces the reference pipeline's external CUDA `fusibile` executable
(reference: depthfusion.py:194-214, README.md:54-74) with a
reprojection-consistency fusion in PyTorch:

  1. probability filter: depth := 0 where prob < threshold
     (reference: depthfusion.py:172-191);
  2. for every reference view, backproject its depth map to world points,
     reproject into every other view, and accept pixels observed
     consistently by >= num_consistent other views (reprojection error
     <= disp_threshold pixels and relative depth agreement); accepted
     positions are averaged over the agreeing views;
  3. optionally, the host-side consolidation fusibile ran: density-based
     outlier removal and a voxel merge (`native/`, C++);
  4. write points + colours to points_mvsnet/consistencyCheck/final3d_model.ply
     (fusibile's artifact path, reference: scripts/utils.py:31-39).

The Gipuma-format export (P matrices, .dmb depths, fake normals;
reference: depthfusion.py:76-169) is kept for the external tool.

The consistency check is a chain of PyTorch ops per view pair on the
device (`device=None` is `cuda:0`; `device="cpu"` runs it on the CPU). JAX
leaves it to XLA (`@jax.jit`, mvsnet_tpu/fusion.py:78-139): no Pallas
kernel is involved, so none is ported. Each view's world points are
computed once and serve both as a reference and as a source (the same op
on the same input as JAX's per-pair backprojection), and every reference
view sums its sources' hits in ascending order, as JAX does.
Scene-block sharding over processes is a split of the reference views
(`shard_index`, `shard_count`; `merge_shards` joins the PLYs).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
from typing import List, Optional

import numpy as np
import torch

from mvsnet_tpu_torch import resolve_device
from mvsnet_tpu_torch.data.transforms import scale_image
from mvsnet_tpu_torch.io.cams import load_cam_txt, projection_matrix
from mvsnet_tpu_torch.io.dmb import write_dmb
from mvsnet_tpu_torch.io.images import load_image
from mvsnet_tpu_torch.io.pfm import load_pfm, write_pfm
from mvsnet_tpu_torch.io.ply import read_ply, write_ply
from mvsnet_tpu_torch.utils.logging import setup_logger
from mvsnet_tpu_torch.utils.paths import mkdir_p

logger = setup_logger("mvsnet_tpu_torch.fusion")


# ---------------------------------------------------------------------------
# probability filter
# ---------------------------------------------------------------------------

def probability_filter(dense_folder: str, prob_threshold: float) -> List[str]:
    """Zero low-confidence depths; writes *_prob_filtered.pfm
    (reference: depthfusion.py:172-191)."""
    depth_folder = os.path.join(dense_folder, "depths_mvsnet")
    names = _image_names(depth_folder)
    for name in names:
        prefix = os.path.splitext(name)[0]
        depth = load_pfm(os.path.join(depth_folder, prefix + "_init.pfm"))
        prob = load_pfm(os.path.join(depth_folder, prefix + "_prob.pfm"))
        depth = np.where(prob < prob_threshold, 0.0, depth).astype(np.float32)
        write_pfm(os.path.join(depth_folder, prefix + "_prob_filtered.pfm"), depth)
    return names


def _image_names(depth_folder: str) -> List[str]:
    return sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(depth_folder, "*.jpg")))


# ---------------------------------------------------------------------------
# consistency fusion
# ---------------------------------------------------------------------------

def _backproject(depth, K_inv, R_T, t):
    """Depth map (H, W) -> world points (H, W, 3).

    x_cam = K^-1 (u+0.5, v+0.5, 1) * d ; X = R^T (x_cam - t).
    """
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=depth.device) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    pix = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)      # (H, W, 3)
    x_cam = (pix @ K_inv.T) * depth[..., None]
    return (x_cam - t) @ R_T.T


def _project(points, K, R, t):
    """World points (..., 3) -> (pixel u, pixel v, cam-space depth)."""
    x_cam = points @ R.T + t
    z = x_cam[..., 2]
    uv = x_cam @ K.T
    zs = torch.where(z == 0, torch.full_like(z, 1e-6), z)
    return uv[..., 0] / zs - 0.5, uv[..., 1] / zs - 0.5, z


def _pair_consistency(ref, src, disp_threshold: float, depth_rel_threshold: float):
    """Two-way reprojection consistency of one reference view against one
    source view (fusion.py:85-139 of the JAX package): project each
    reference world point into the source, sample the source depth at the
    nearest pixel (round half to even, indices clipped), take that source
    observation's world point, reproject it into the reference camera, and
    accept it when it lands within disp_threshold pixels of the original
    pixel (the integer grid) with relative depth agreement.

    Returns (ok mask (H, W), source-observation world points (H, W, 3))."""
    Hs, Ws = src["depth"].shape
    u, v, z = _project(ref["points"], src["K"], src["R"], src["t"])
    # clamped first so that the cast to an integer stays defined; the
    # bounds test and the rounding of every in-range value are unchanged
    ui = torch.round(u.clamp(-1.0, float(Ws))).to(torch.int64)
    vi = torch.round(v.clamp(-1.0, float(Hs))).to(torch.int64)
    inb = (ui >= 0) & (ui < Ws) & (vi >= 0) & (vi < Hs) & (z > 0)
    ui = ui.clamp(0, Ws - 1)
    vi = vi.clamp(0, Hs - 1)
    d_src = src["depth"][vi, ui]                                  # (H, W)
    hit = src["points"][vi, ui]                                   # (H, W, 3)
    u2, v2, z2 = _project(hit, ref["K"], ref["R"], ref["t"])
    Hr, Wr = ref["depth"].shape
    uu = torch.arange(Wr, dtype=torch.float32, device=u2.device)[None, :]
    vv = torch.arange(Hr, dtype=torch.float32, device=u2.device)[:, None]
    pix_ok = ((u2 - uu).abs() <= disp_threshold) & ((v2 - vv).abs() <= disp_threshold)
    rel_ok = (z2 - ref["depth"]).abs() <= depth_rel_threshold * ref["depth"].abs()
    ok = ref["valid"] & inb & (d_src > 0) & rel_ok & pix_ok
    return ok, hit


def prepare_views(depths, cams, device) -> list:
    """Per view, on `device`: the depth map, K, K^-1 (inverted in float64,
    then float32, as JAX does), R, t, the valid mask and the world points."""
    views = []
    for depth, cam in zip(depths, cams):
        cam = np.asarray(cam)
        view = {
            "depth": torch.as_tensor(np.asarray(depth, np.float32), device=device),
            "K": torch.as_tensor(cam[1, :3, :3], dtype=torch.float32, device=device),
            "K_inv": torch.as_tensor(np.linalg.inv(cam[1, :3, :3]), dtype=torch.float32,
                                     device=device),
            "R": torch.as_tensor(cam[0, :3, :3], dtype=torch.float32, device=device),
            "t": torch.as_tensor(cam[0, :3, 3], dtype=torch.float32, device=device),
        }
        view["valid"] = view["depth"] > 0
        view["points"] = _backproject(view["depth"], view["K_inv"], view["R"].T, view["t"])
        views.append(view)
    return views


@torch.inference_mode()
def consistency(views: list, i: int, disp_threshold: float = 0.25,
                depth_rel_threshold: float = 0.01):
    """Reference view `i` of `prepare_views` against every other view, on
    their device: (count (H, W) int32 of consistent sources, accum (H, W,
    3): the pixel's world point plus its consistent sources' hits, summed
    in ascending view order)."""
    ref = views[i]
    count = torch.zeros(ref["depth"].shape, dtype=torch.int32, device=ref["depth"].device)
    accum = ref["points"]
    for j, src in enumerate(views):
        if j == i:
            continue
        ok, hit = _pair_consistency(ref, src, disp_threshold, depth_rel_threshold)
        count = count + ok.to(torch.int32)
        accum = accum + torch.where(ok[..., None], hit, torch.zeros((), device=hit.device))
    return count, accum


@torch.inference_mode()
def fuse_reference(views: list, i: int, disp_threshold: float = 0.25,
                   num_consistent: int = 3, depth_rel_threshold: float = 0.01):
    """Fuse reference view `i` against every other view of `prepare_views`:
    returns (keep (H, W) bool, fused points (n, 3) float32), both numpy,
    the points in row-major pixel order: each kept pixel's `accum` over
    (count + 1) (float64 on the host, then float32 as the PLY stores
    them)."""
    count, accum = consistency(views, i, disp_threshold, depth_rel_threshold)
    keep = views[i]["valid"] & (count >= num_consistent)
    kept = accum[keep].cpu().numpy()
    n = count[keep].cpu().numpy()
    points = (kept / (n[:, None] + 1.0)).astype(np.float32)
    return keep.cpu().numpy(), points


def _view_image(path: str, shape) -> np.ndarray:
    """The reference image at the depth map's size (H, W): resized by the
    port's cv2-equal `scale_image` where the sizes differ."""
    image = load_image(path)
    if image.shape[:2] != tuple(shape):
        image = scale_image(image, shape[1] / image.shape[1])
        if image.shape[:2] != tuple(shape):
            raise ValueError(f"{path}: the image does not scale to the depth map's {shape}")
    return image


def fuse_session(dense_folder: str, prob_threshold: float = 0.8,
                 disp_threshold: float = 0.25, num_consistent: int = 3,
                 depth_rel_threshold: float = 0.01,
                 output_path: Optional[str] = None,
                 voxel_size: float = 0.0,
                 min_neighbors: int = 0,
                 shard_index: int = 0,
                 shard_count: int = 1,
                 device=None) -> str:
    """Probability-filter + consistency-fuse one session; returns the PLY's
    path. The pair checks run on `device` (None: `cuda:0`, raising without
    CUDA; "cpu" runs them on the CPU).

    shard_index/shard_count: scene-block parallelism across processes
    (SURVEY §7.8): each fuses a disjoint subset of REFERENCE views against
    all source views and writes final3d_model.shard<k>.ply; merge with
    merge_shards()."""
    device = resolve_device(device)
    depth_folder = os.path.join(dense_folder, "depths_mvsnet")
    names = probability_filter(dense_folder, prob_threshold)
    if not names:
        raise FileNotFoundError(f"no predictions under {depth_folder}")

    depths, cams, images = [], [], []
    for name in names:
        prefix = os.path.splitext(name)[0]
        depth = load_pfm(os.path.join(depth_folder, prefix + "_prob_filtered.pfm"))
        depths.append(depth)
        cams.append(load_cam_txt(os.path.join(depth_folder, prefix + ".txt")))
        images.append(_view_image(os.path.join(depth_folder, name), depth.shape[:2]))
    views = prepare_views(depths, cams, device)

    all_points, all_colors = [], []
    for i in range(len(views)):
        if shard_count > 1 and i % shard_count != shard_index:
            continue
        keep, points = fuse_reference(views, i, disp_threshold, num_consistent,
                                      depth_rel_threshold)
        if not len(points):
            continue
        all_points.append(points)
        all_colors.append(images[i][keep])
        logger.info("view %d/%d: %d fused points", i + 1, len(views), len(points))

    if output_path is None:
        out_dir = os.path.join(dense_folder, "points_mvsnet", "consistencyCheck")
        mkdir_p(out_dir)
        name = ("final3d_model.ply" if shard_count == 1
                else f"final3d_model.shard{shard_index}.ply")
        output_path = os.path.join(out_dir, name)
    if all_points:
        points = np.concatenate(all_points, axis=0)
        colors = np.concatenate(all_colors, axis=0)
    else:
        points = np.zeros((0, 3), np.float32)
        colors = np.zeros((0, 3), np.uint8)

    # native consolidation (the stage fusibile ran on the GPU): density-based
    # outlier rejection, then voxel-grid dedup/merge
    if len(points) and min_neighbors > 0 and voxel_size > 0:
        from mvsnet_tpu_torch import native
        keep = native.radius_outlier_removal(points, voxel_size * 3.0, min_neighbors)
        logger.info("outlier removal kept %d/%d points", int(keep.sum()), len(points))
        points, colors = points[keep], colors[keep]
    if len(points) and voxel_size > 0:
        from mvsnet_tpu_torch import native
        points, colors = native.voxel_downsample(points, colors, voxel_size)
        logger.info("voxel downsample -> %d points (voxel %.3f)", len(points), voxel_size)

    write_ply(output_path, points, colors=colors)
    logger.info("Wrote %d points to %s", len(points), output_path)
    return output_path


def merge_shards(dense_folder: str, output_path: Optional[str] = None) -> str:
    """Concatenate shard PLYs (from multi-process fusion) into the final cloud."""
    out_dir = os.path.join(dense_folder, "points_mvsnet", "consistencyCheck")
    shard_paths = sorted(glob.glob(os.path.join(out_dir, "final3d_model.shard*.ply")))
    if not shard_paths:
        raise FileNotFoundError(f"no shard PLYs under {out_dir}")
    points, colors = [], []
    for p in shard_paths:
        pts, cols = read_ply(p)
        points.append(pts)
        if cols is not None:
            colors.append(cols)
    points = np.concatenate(points, axis=0)
    colors = np.concatenate(colors, axis=0) if colors else None
    if output_path is None:
        output_path = os.path.join(out_dir, "final3d_model.ply")
    write_ply(output_path, points, colors=colors)
    logger.info("Merged %d shards -> %d points at %s",
                len(shard_paths), len(points), output_path)
    return output_path


# ---------------------------------------------------------------------------
# gipuma export (compat with the external fusibile tool)
# ---------------------------------------------------------------------------

def mvsnet_to_gipuma(dense_folder: str, gipuma_point_folder: str) -> None:
    """(reference: depthfusion.py:124-169)"""
    depth_folder = os.path.join(dense_folder, "depths_mvsnet")
    names = _image_names(depth_folder)
    cam_folder = os.path.join(gipuma_point_folder, "cams")
    image_folder = os.path.join(gipuma_point_folder, "images")
    for d in (gipuma_point_folder, cam_folder, image_folder):
        mkdir_p(d)

    for name in names:
        prefix = os.path.splitext(name)[0]
        cam = load_cam_txt(os.path.join(depth_folder, prefix + ".txt"))
        P = projection_matrix(cam)
        with open(os.path.join(cam_folder, name + ".P"), "w") as f:
            for r in range(3):
                f.write(" ".join(str(P[r, c]) for c in range(4)) + " \n")
            f.write("\n")
        shutil.copy(os.path.join(depth_folder, name),
                    os.path.join(image_folder, name))

    gipuma_prefix = "2333__"
    for name in names:
        prefix = os.path.splitext(name)[0]
        sub = os.path.join(gipuma_point_folder, gipuma_prefix + prefix)
        mkdir_p(sub)
        depth = load_pfm(os.path.join(depth_folder, prefix + "_prob_filtered.pfm"))
        write_dmb(os.path.join(sub, "disp.dmb"), depth)
        # constant fake normals (1,1,1)/sqrt(3), masked by valid depth
        normal = np.ones((depth.shape[0], depth.shape[1], 3), np.float32) / 1.732050808
        normal *= (depth > 0)[..., None].astype(np.float32)
        write_dmb(os.path.join(sub, "normals.dmb"), normal)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--prob_threshold", type=float, default=0.8)
    p.add_argument("--disp_threshold", type=float, default=0.25)
    p.add_argument("--num_consistent", type=int, default=3)
    p.add_argument("--depth_rel_threshold", type=float, default=0.01)
    p.add_argument("--voxel_size", type=float, default=0.0,
                   help="voxel edge (scene units) for native point consolidation; 0 = off")
    p.add_argument("--min_neighbors", type=int, default=0,
                   help="density outlier filter: min points within 3*voxel_size; 0 = off")
    p.add_argument("--mode", default="native",
                   choices=["native", "gipuma-export", "merge-shards"],
                   help="native: in-framework fusion to PLY; gipuma-export: "
                        "write fusibile-compatible inputs; merge-shards: "
                        "combine multi-process shard PLYs")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="where the consistency check runs: cuda:0 by default, 'cpu' for "
                        "the plain path")
    args = p.parse_args(argv)

    if args.mode == "native":
        fuse_session(args.dense_folder, args.prob_threshold, args.disp_threshold,
                     args.num_consistent, args.depth_rel_threshold,
                     voxel_size=args.voxel_size, min_neighbors=args.min_neighbors,
                     shard_index=args.shard_index, shard_count=args.shard_count,
                     device=args.device)
    elif args.mode == "merge-shards":
        merge_shards(args.dense_folder)
    else:
        point_folder = os.path.join(args.dense_folder, "points_mvsnet")
        mkdir_p(point_folder)
        probability_filter(args.dense_folder, args.prob_threshold)
        mvsnet_to_gipuma(args.dense_folder, point_folder)
    return 0


if __name__ == "__main__":
    sys.exit(main())
