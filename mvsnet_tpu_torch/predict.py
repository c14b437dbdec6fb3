"""Prediction library (counterpart of mvsnet_tpu/predict.py; reference:
mvsnet/predictlib.py): the data iterator, `Predictor` (the 3D-CNN graph
with or without refinement, and the GRU graph, on one device or over a
mesh), the PFM / PNG / cam output writers with a background writer thread,
and the results CSV.

Weights come from a seed, from a state dict (`convert.state_dict_from_jax`,
`checkpoint.restore_tree(...)["model"]`), or from a checkpoint directory of
the port (`model_dir`, `ckpt_step`; a JAX checkpoint converts with
`tools/jax_ckpt_to_torch.py`).
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mvsnet_tpu_torch import checkpoint as ckpt
from mvsnet_tpu_torch import resolve_device
from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.data import ClusterGenerator
from mvsnet_tpu_torch.data.transforms import scale_image
from mvsnet_tpu_torch.io.cams import write_cam_txt
from mvsnet_tpu_torch.io.images import (write_confidence_png, write_depth_png, write_image,
                                        write_inverse_depth_png)
from mvsnet_tpu_torch.io.pfm import write_pfm
from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn
from mvsnet_tpu_torch.parallel.infer_step import make_sharded_forward, make_sharded_gru_forward
from mvsnet_tpu_torch.parallel.mesh import factorize_devices, make_mesh
from mvsnet_tpu_torch.utils.logging import setup_logger

logger = setup_logger("mvsnet_tpu_torch.predict")


def setup_data_iterator(input_dir: str, mcfg: ModelConfig, benchmark: bool,
                        max_clusters_per_session: Optional[int] = None,
                        batch_size: int = 1):
    """A `ClusterGenerator` over `input_dir` in "test" mode (sessions with
    ground truth under `<input_dir>/test`) or "inference" mode (the dir's
    own sessions) (predict.py:38-48; reference: predictlib.py:33-56)."""
    return ClusterGenerator(
        input_dir, mcfg.view_num, mcfg.width, mcfg.height, mcfg.max_d,
        mcfg.interval_scale, mcfg.base_image_size,
        mode="test" if benchmark else "inference", output_scale=mcfg.sample_scale,
        max_clusters_per_session=max_clusters_per_session)


def _default_mesh(device):
    """Inside a process group of more than one rank: JAX's serving mesh
    (1, data * depth, space) from `factorize_devices(world)` (inference
    batches are tiny, so the data axis stays 1). Gloo ranks stage CUDA
    tensors through the host unless the CPU is asked for."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    da, de, sp = factorize_devices(dist.get_world_size())
    if dist.get_backend() == "nccl":
        backend = "nccl"
    else:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "gloo-cuda"
    return make_mesh(shape=(1, da * de, sp), backend=backend)


class Predictor:
    """Eval MVSNet, constructed as JAX's `Predictor(mcfg, model_dir,
    ckpt_step, num_devices)` (predict.py:59) or with the port's keywords.

    `model_dir` restores the weights of the port's checkpoint
    `<model_dir>/<regularization>/<network_mode>/<ckpt_step>` (the latest
    with `ckpt_step=None`); `state_dict` loads given weights; with neither
    the weights are seeded by `seed`. `num_devices` None or 1 is one
    device; a larger number needs a process group of that many ranks (one
    process a card, torchrun), inside which every rank constructs its own
    Predictor with the same arguments and calls `predict` with the same
    inputs. On one device `device=None` is `cuda:0` and raises without
    CUDA; `device="cpu"` runs the plain path. Over a mesh of more than one
    rank (`mesh`, or by default inside a process group) `device=None` is
    the rank's own device, which must be a card; the forward is
    `make_sharded_forward`'s, or for the GRU `make_sharded_gru_forward`'s
    (the maps split over the ranks). With refinement the 3D-CNN graph
    returns the refined depth and the residual; the GRU graph ignores
    refinement and returns a zero residual, as in JAX."""

    def __init__(self, mcfg: ModelConfig, model_dir: Optional[str] = None,
                 ckpt_step: Optional[int] = None, num_devices: Optional[int] = None, *,
                 state_dict: Optional[dict] = None, seed: int = 0, device=None, mesh=None):
        if model_dir is not None and state_dict is not None:
            raise ValueError("pass model_dir or state_dict, not both")
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if num_devices not in (None, 1, world):
            raise ValueError(
                f"num_devices={num_devices} needs a process group of {num_devices} ranks, one "
                f"process a card (torchrun --nproc_per_node={num_devices}); this process "
                f"group has {world}")
        self.mcfg = mcfg
        if mesh is None and num_devices != 1:
            mesh = _default_mesh(device)
        self.mesh = mesh
        if self.mesh is not None and self.mesh.size > 1:
            if device is None and self.mesh.device.type != "cuda":
                raise RuntimeError("device=None runs on the rank's card, and this mesh "
                                   f"puts the rank on {self.mesh.device}; pass "
                                   "device='cpu' to run the plain path")
            self.device = self.mesh.device if device is None else resolve_device(device)
            if self.device != self.mesh.device:
                raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
        else:
            self.mesh = None
            self.device = resolve_device(device)
        model = MVSNet(mcfg, seed=seed)
        if model_dir is not None:
            state_dict = ckpt.restore_tree(model_dir, mcfg.regularization, mcfg.network_mode,
                                           ckpt_step)["model"]
            logger.info("Restored model from %s step %s", model_dir, ckpt_step)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        # forward(images, cams, depth_start, depth_interval, depth_end)
        if mcfg.regularization == "GRU":
            gru = (make_sharded_gru_forward(self.model, self.mesh) if self.mesh is not None
                   else lambda im, ca, ds, de: self.model.forward_gru_wta(im, ca, ds, None, de))

            def forward(images, cams, ds, di, de):
                depth, prob = gru(images, cams, ds, de)
                return depth, prob, torch.zeros_like(depth)
            self._forward = forward
        elif self.mesh is not None:
            sharded = make_sharded_forward(self.model, self.mesh)
            self._forward = lambda im, ca, ds, di, de: sharded(im, ca, ds, di)
        else:
            self._forward = lambda im, ca, ds, di, de: apply_forward_3dcnn(
                self.model, im, ca, ds, di)

    def _tensor(self, a):
        if not torch.is_tensor(a):
            a = np.array(a, dtype=np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def predict(self, images, cams, depth_start, depth_interval, depth_end,
                fetch: bool = True):
        """(depth_map, prob_map, residual), each (B, h, w, 1); with
        refinement the refined depth map and the residual, at the
        refinement's resolution (the images' with
        `upsample_before_refinement`), else the residual is zeros. fetch=True
        returns numpy arrays after the device finishes; fetch=False returns
        the device tensors as soon as the work is queued. As in JAX
        (mvsnet_tpu/predict.py:110-139), the 3D-CNN graph reads
        `depth_interval` and not `depth_end`, the GRU graph `depth_end` and
        not `depth_interval`."""
        out = self._forward(self._tensor(images), self._tensor(cams),
                            self._tensor(depth_start), self._tensor(depth_interval),
                            self._tensor(depth_end))
        if not fetch:
            return out
        return tuple(o.cpu().numpy() for o in out)


def depth_params_from_cams(scaled_cams):
    """depth_start, depth_interval, depth_num, depth_end from the scaled
    reference cam (reference: predictlib.py:182-199)."""
    depth_start = scaled_cams[:, 0, 1, 3, 0]
    depth_interval = scaled_cams[:, 0, 1, 3, 1]
    depth_num = int(scaled_cams[0, 0, 1, 3, 2])
    depth_end = scaled_cams[:, 0, 1, 3, 3]
    return depth_start, depth_interval, depth_num, depth_end


def _host(x):
    """A device tensor (fetched here, in the writer's thread) or an array
    as a numpy array."""
    return x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_output_slice(output_dir: str, depth_map, prob_map, images, cams,
                       full_cams, full_images, index, residual_depth_map=None,
                       upsample: bool = False, sample_scale: float = 0.25,
                       visualize: bool = False):
    """Write one prediction (predict.py:173-206; reference:
    predictlib.py:105-159): `<index>_init.pfm`, `<index>_prob.pfm`, the
    depth and confidence PNGs, the reference image `<index>.jpg` and its
    cam `<index>.txt`; with `upsample` (the depth is at the full images'
    resolution) the full images' cam and the prob map scaled up by nearest
    neighbour; with `visualize` the inverse-depth PNG and the residual PFM."""
    depth_map = np.squeeze(_host(depth_map))
    prob_map = np.squeeze(_host(prob_map))
    if upsample:
        ref_image = np.squeeze(full_images)[0]
        ref_cam = np.squeeze(full_cams)[0]
        prob_map = scale_image(prob_map, 1.0 / sample_scale, "nearest")
    else:
        ref_image = np.squeeze(images)[0]
        ref_cam = np.squeeze(cams)[0]
    index = int(np.squeeze(index))

    write_pfm(os.path.join(output_dir, f"{index}_init.pfm"), depth_map.astype(np.float32))
    write_pfm(os.path.join(output_dir, f"{index}_prob.pfm"), prob_map.astype(np.float32))
    write_depth_png(os.path.join(output_dir, f"{index}_depth.png"), depth_map)
    write_confidence_png(os.path.join(output_dir, f"{index}_prob.png"), prob_map)
    # reference image: de-normalize centered floats to displayable range
    img = ref_image
    if img.dtype != np.uint8:
        img = img - img.min()
        peak = img.max()
        img = (255 * img / peak if peak > 0 else img).astype(np.uint8)
    write_image(os.path.join(output_dir, f"{index}.jpg"), img)
    write_cam_txt(os.path.join(output_dir, f"{index}.txt"), ref_cam)
    if visualize:
        write_inverse_depth_png(
            os.path.join(output_dir, f"{index}_depth_inverse.png"), depth_map)
        if residual_depth_map is not None:
            write_pfm(os.path.join(output_dir, f"{index}_residual.pfm"),
                      np.squeeze(_host(residual_depth_map)).astype(np.float32))


def write_output(output_dir, depth_maps, prob_maps, images, cams, full_cams,
                 full_images, indices, residuals=None, upsample=False,
                 sample_scale=0.25, visualize=False):
    """Write a batch of predictions (predict.py:209-221; reference:
    predictlib.py:162-177). Device tensors are fetched here, once a batch."""
    start = time.time()
    depth_maps, prob_maps = _host(depth_maps), _host(prob_maps)
    residuals = None if residuals is None else _host(residuals)
    for i in range(depth_maps.shape[0]):
        write_output_slice(
            output_dir, depth_maps[i], prob_maps[i], images[i], cams[i],
            full_cams[i], full_images[i], indices[i],
            None if residuals is None else residuals[i],
            upsample=upsample, sample_scale=sample_scale, visualize=visualize)
    logger.info("Time to write prediction results: %.3f s", time.time() - start)


class AsyncOutputWriter:
    """Output writes on one worker thread, in order (predict.py:224-277).

    With `Predictor.predict(fetch=False)` the caller hands over the device
    tensors as soon as the work is queued; the worker's `.cpu()` in
    `write_output` waits for the device, and the caller feeds the next
    cluster meanwhile. At most `max_pending` batches wait; an exception in
    the worker is raised by the `write` that finds the queue full, by
    `flush` or by `close`. Leaving the `with` block on an exception drops
    the queued writes without waiting for them."""

    def __init__(self, max_pending: int = 4, write_fn=None):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="output-writer")
        self._pending = deque()
        self._max = max(1, int(max_pending))
        self._write_fn = write_fn or write_output

    def write(self, *args, **kwargs):
        while len(self._pending) >= self._max:
            self._pending.popleft().result()   # re-raises worker errors
        self._pending.append(self._pool.submit(self._write_fn, *args, **kwargs))

    def flush(self):
        while self._pending:
            self._pending.popleft().result()

    def close(self):
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self._pool.shutdown(wait=False, cancel_futures=True)
        return False


RESULTS_HEADER = "model_dir, ckpt_step, loss, less_one, less_three, debug \n"


def ensure_header_exists(path: str):
    """The results CSV starts with `RESULTS_HEADER` (predict.py:280-290;
    reference: predictlib.py:231-253)."""
    try:
        with open(path) as f:
            lines = f.readlines()
            if lines and lines[0] == RESULTS_HEADER:
                return
    except OSError:
        pass
    with open(path, "a+") as f:
        f.write(RESULTS_HEADER)


def write_results(path: str, model_dir, ckpt_step, loss, less_one, less_three, debug):
    """Append a benchmark row (predict.py:293-302; reference:
    predictlib.py:256-266); a failed write is logged, not raised."""
    try:
        ensure_header_exists(path)
        with open(path, "a+") as f:
            f.write(f"{model_dir}, {ckpt_step}, {loss}, {less_one}, "
                    f"{less_three}, {debug} \n")
    except OSError as e:
        logger.error("Failed to write results: %s", e)
