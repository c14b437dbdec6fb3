"""Covisibility cluster: one reference image + its best covisible views
(a copy of mvsnet_tpu/data/cluster.py).

Parity with reference mvs_data_generation/mvs_cluster.py: session layout
  <session>/images/<i>.jpg
  <session>/cameras/<i>.json     (intrinsics fx,fy,px,py + 4x4 pose)
  <session>/depths/<i>.png       (uint16, millimeters)
  <session>/covisibility.json    (ref index -> {views, min_depth, max_depth})
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from mvsnet_tpu_torch.data import transforms as T
from mvsnet_tpu_torch.io.cams import cam_from_camera_json
from mvsnet_tpu_torch.io.images import load_depth_png, load_image
from mvsnet_tpu_torch.utils.logging import setup_logger

logger = setup_logger("mvsnet_tpu_torch.cluster")


class Cluster:
    def __init__(self, session_dir: str, ref_index: int, views: List[int],
                 min_depth: float, max_depth: float, view_num: int,
                 image_width: int = 1024, image_height: int = 768,
                 depth_num: int = 256, interval_scale: float = 1.0):
        self.session_dir = session_dir
        self.ref_index = int(ref_index)
        self.views = views
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.view_num = view_num
        self.image_width = image_width
        self.image_height = image_height
        self.depth_num = depth_num
        self.interval_scale = interval_scale
        self.rescale = 1.0
        self.original_image_shape: Optional[tuple] = None
        self._set_indices()

    def to_json(self):
        return {
            "session_dir": self.session_dir,
            "ref_index": self.ref_index,
            "views": self.views,
            "min_depth": self.min_depth,
            "max_depth": self.max_depth,
            "view_num": self.view_num,
            "image_width": self.image_width,
            "image_height": self.image_height,
            "depth_num": self.depth_num,
            "interval_scale": self.interval_scale,
        }

    @staticmethod
    def from_json(data):
        return Cluster(**data)

    # -- paths ------------------------------------------------------------
    def image_path(self, index):
        return os.path.join(self.session_dir, "images", f"{index}.jpg")

    def depth_path(self, index):
        return os.path.join(self.session_dir, "depths", f"{index}.png")

    def camera_path(self, index):
        return os.path.join(self.session_dir, "cameras", f"{index}.json")

    # -- loading ----------------------------------------------------------
    def _set_indices(self):
        """Pad with copies of the reference when covisible views are scarce
        (reference: mvs_cluster.py:129-140)."""
        indices = [self.ref_index] + [int(v) for v in self.views]
        while len(indices) < self.view_num:
            indices.append(self.ref_index)
        self.indices = indices[: self.view_num]

    def load_image(self, index):
        return load_image(self.image_path(index))

    def load_depth(self, index):
        try:
            return load_depth_png(self.depth_path(index))
        except Exception:
            logger.warning("Depth map at %s does not exist", self.depth_path(index))
            return None

    def load_camera(self, index):
        with open(self.camera_path(index)) as f:
            camera_data = json.load(f)
        return cam_from_camera_json(
            camera_data, self.min_depth, self.max_depth, self.depth_num,
            self.interval_scale)

    def cameras(self):
        return [self.load_camera(i) for i in self.indices]

    def images(self):
        images = [self.load_image(i) for i in self.indices]
        self.set_rescale(images)
        if images:
            self.original_image_shape = images[0].shape
        return images

    def reference_depth(self):
        return self.load_depth(self.ref_index)

    def masked_reference_depth(self):
        """GT depth resized to the reference image scale, out-of-range zeroed
        (reference: mvs_cluster.py:166-177)."""
        depth = self.reference_depth()
        if depth is None:
            raise FileNotFoundError(self.depth_path(self.ref_index))
        if self.original_image_shape is not None and depth.shape[0] != self.original_image_shape[0]:
            scale = float(self.original_image_shape[0]) / float(depth.shape[0])
            depth = T.scale_image(depth, scale=scale, interpolation="nearest")
        return T.mask_depth_image(depth, self.min_depth, self.max_depth)

    def set_rescale(self, images):
        """Uniform scale so every view covers (image_width, image_height)
        (reference: mvs_cluster.py:179-192)."""
        h_scale = 0.0
        w_scale = 0.0
        for im in images:
            h_scale = max(h_scale, float(self.image_height) / im.shape[0])
            w_scale = max(w_scale, float(self.image_width) / im.shape[1])
        self.rescale = max(h_scale, w_scale)
        return self.rescale
