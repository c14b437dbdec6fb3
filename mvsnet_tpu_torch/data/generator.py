"""ClusterGenerator: serves batches for training / validation / test /
inference from mvs-training session directories (a copy of
mvsnet_tpu/data/generator.py; images decode through `io/images`).

Parity with reference mvs_data_generation/cluster_generator.py:28-286,
including the metadata cache, sessions_frac / max_clusters_per_session
dials, per-cluster error skipping, GRU cam flipping (train yields each
cluster twice, second with the sweep reversed), and the test/inference
tuple formats.

Additions over the reference: deterministic seeding, sharding (shard k
of n iterates a disjoint slice of clusters) and epoch-bounded iteration
for functional training loops.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from typing import Iterator, List, Optional

import numpy as np

from mvsnet_tpu_torch.data import transforms as ut
from mvsnet_tpu_torch.data.cluster import Cluster
from mvsnet_tpu_torch.utils.logging import setup_logger

logger = setup_logger("mvsnet_tpu_torch.generator")


class ClusterGenerator:
    def __init__(self, data_dir: str, view_num: int = 3, image_width: int = 1024,
                 image_height: int = 768, depth_num: int = 256,
                 interval_scale: float = 1.0, base_image_size: int = 1,
                 include_empty: bool = False, mode: str = "train",
                 rescaling: bool = True, output_scale: float = 0.25,
                 flip_cams: bool = True, sessions_frac: float = 1.0,
                 max_clusters_per_session: Optional[int] = None,
                 clear_cache: bool = False, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        self.data_dir = data_dir
        self.mode = mode
        self.view_num = view_num
        self.image_width = image_width
        self.image_height = image_height
        self.depth_num = depth_num
        self.interval_scale = interval_scale
        self.base_image_size = base_image_size
        self.include_empty = include_empty
        self.rescaling = rescaling
        self.output_scale = output_scale
        self.flip_cams = flip_cams
        self.sessions_frac = sessions_frac
        self.max_clusters_per_session = max_clusters_per_session
        self.clear_cache = clear_cache
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._set_sessions_dir()
        self.parse_sessions()

    def _set_sessions_dir(self):
        """train/val/test subdirs; inference = the dir itself
        (reference: cluster_generator.py:58-70)."""
        if self.mode in ("train", "val", "test"):
            self.sessions_dir = os.path.join(self.data_dir, self.mode)
        elif self.mode == "inference":
            self.sessions_dir = self.data_dir
        else:
            raise ValueError(f"unknown mode {self.mode!r}")

    # -- session parsing --------------------------------------------------
    def parse_sessions(self) -> List[Cluster]:
        cache_path = os.path.join(self.sessions_dir, "clusters.pickle")
        clusters: List[Cluster] = []
        if (os.path.exists(cache_path) and not self.clear_cache
                and self.mode != "inference"):
            logger.info("Loading cluster cache from %s", cache_path)
            with open(cache_path, "rb") as f:
                for data in pickle.load(f):
                    clusters.append(Cluster(
                        data["session_dir"], data["ref_index"], data["views"],
                        data["min_depth"], data["max_depth"], data["view_num"],
                        self.image_width, self.image_height, self.depth_num,
                        self.interval_scale))
        elif self.mode == "inference":
            self._load_clusters(self.sessions_dir, clusters)
        else:
            sessions = sorted(
                f for f in os.listdir(self.sessions_dir)
                if not f.startswith(".") and not f.endswith(".txt")
                and os.path.isdir(os.path.join(self.sessions_dir, f)))
            num_sessions = int(len(sessions) * self.sessions_frac)
            logger.info("%d/%d sessions used for %s", num_sessions, len(sessions), self.mode)
            for s, session in enumerate(sessions[:num_sessions]):
                session_dir = os.path.join(self.sessions_dir, session)
                try:
                    self._load_clusters(session_dir, clusters)
                except Exception as e:  # bad session: skip, don't die
                    logger.debug("Failed to load %s: %s", session_dir, e)
            self._cache_clusters(clusters, cache_path)

        if self.mode in ("train", "val"):
            random.Random(self.seed).shuffle(clusters)
        if self.shard_count > 1:
            clusters = clusters[self.shard_index::self.shard_count]
        logger.info("%d clusters will be used to %s", len(clusters), self.mode)
        self.clusters = clusters
        return clusters

    def _cache_clusters(self, clusters, path):
        try:
            with open(path, "wb") as f:
                pickle.dump([c.to_json() for c in clusters], f, -1)
        except OSError as e:
            logger.warning("Could not write cluster cache %s: %s", path, e)

    def _load_clusters(self, session_dir, clusters):
        """(reference: cluster_generator.py:139-156)"""
        with open(os.path.join(session_dir, "covisibility.json")) as f:
            data = json.load(f)
        max_clusters = len(data)
        if self.max_clusters_per_session is not None:
            max_clusters = self.max_clusters_per_session
        added = 0
        for d in data:
            if not self.include_empty and not data[d]["views"]:
                continue
            if added < max_clusters:
                clusters.append(Cluster(
                    session_dir, int(d), data[d]["views"], data[d]["min_depth"],
                    data[d]["max_depth"], self.view_num, self.image_width,
                    self.image_height, self.depth_num, self.interval_scale))
                added += 1

    # -- iteration --------------------------------------------------------
    def __len__(self):
        n = len(self.clusters)
        if self.mode in ("train", "val") and self.flip_cams:
            return n * 2
        return n

    def _train_sample(self, c: Cluster):
        """(images, cams, rescaled_depth, full_depth)
        (reference: cluster_generator.py:166-219)."""
        images = c.images()
        cams = c.cameras()
        depth = c.masked_reference_depth()
        images, cams, depth = ut.scale_mvs_input(images, cams, depth, c.rescale)
        images, cams, depth = ut.crop_mvs_input(
            images, cams, self.image_width, self.image_height,
            self.base_image_size, depth)
        images = np.stack(ut.center_images(images), axis=0).astype(np.float32)
        rescaled_depth = ut.scale_and_reshape_depth(depth, self.output_scale).astype(np.float32)
        full_depth = ut.reshape_depth(depth).astype(np.float32)
        cams = np.stack([ut.scale_camera(cam, self.output_scale) for cam in cams],
                        axis=0).astype(np.float32)
        return images, cams, rescaled_depth, full_depth

    def _eval_sample(self, c: Cluster, with_gt: bool):
        """(scaled_images, centered_input_images, scaled_cams, full_cams
        [, depth], index, session_dir) (reference: cluster_generator.py:234-286)."""
        images = c.images()
        cams = c.cameras()
        if with_gt:
            depth = c.masked_reference_depth()
            images, cams, depth = ut.scale_mvs_input(images, cams, depth, c.rescale)
            cropped_images, cropped_cams, depth = ut.crop_mvs_input(
                images, cams, self.image_width, self.image_height,
                self.base_image_size, depth)
            depth = ut.reshape_depth(depth).astype(np.float32)
        else:
            images, cams = ut.scale_mvs_input(images, cams, scale=c.rescale)
            cropped_images, cropped_cams = ut.crop_mvs_input(
                images, cams, self.image_width, self.image_height,
                self.base_image_size)
            depth = None
        full_cams = np.stack(cropped_cams, axis=0).astype(np.float32)
        input_images = np.stack(
            [ut.center_image(im) for im in cropped_images], axis=0).astype(np.float32)
        output_images, output_cams = ut.scale_mvs_input(
            list(cropped_images), [np.copy(cam) for cam in cropped_cams],
            scale=self.output_scale)
        output_images = np.stack(output_images, axis=0).astype(np.float32)
        output_cams = np.stack(output_cams, axis=0).astype(np.float32)
        if with_gt:
            return (output_images, input_images, output_cams, full_cams, depth,
                    c.ref_index, c.session_dir)
        return (output_images, input_images, output_cams, full_cams,
                c.ref_index, c.session_dir)

    def cluster_samples(self, c: Cluster) -> list:
        """Decode ONE cluster into its sample tuple(s).

        The per-cluster unit of work for concurrent loaders
        (data/loader.py): train/val clusters yield 1 sample (2 with the GRU
        cam flip, reference: cluster_generator.py:217-219), eval clusters 1.
        Failures skip the cluster with a warning, not fatally (reference:
        cluster_generator.py:221-224).
        """
        try:
            if self.mode in ("train", "val"):
                images, cams, rescaled_depth, full_depth = self._train_sample(c)
                out = [(images, cams, rescaled_depth, full_depth)]
                if self.flip_cams:
                    flipped = np.copy(cams)
                    flipped[0] = ut.flip_cams(cams, self.depth_num)[0]
                    out.append((images, flipped, rescaled_depth, full_depth))
                return out
            return [self._eval_sample(c, self.mode == "test")]
        except Exception as e:
            logger.warning("Cluster %s at %s failed: %s. Skipping!",
                           c.indices, c.session_dir, e)
            return []

    def iterate_once(self) -> Iterator:
        """One pass over the clusters (an epoch)."""
        for c in self.clusters:
            yield from self.cluster_samples(c)

    def __iter__(self):
        """Endless iterator (reference semantics: loops forever)."""
        while True:
            yield from self.iterate_once()
