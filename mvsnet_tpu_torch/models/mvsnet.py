"""MVSNet 3D-CNN and R-MVSNet ConvGRU graphs (counterpart of
mvsnet_tpu/models/mvsnet.py:50-285: `_GRUStep`, `apply_forward_3dcnn`,
`MVSNet._extract_features`, `forward_3dcnn`, `gru_cost_sweep`,
`forward_prob_recurrent`, `forward_gru_wta` and `refine`).

Features of the V views run as one batch of B*V images; homographies in
float32; the fused cost volume (kernel K1). The 3D-CNN graph runs RegNetUS0
and the fused soft-argmin + probability tail; the GRU graphs run the
three-cell ConvGRU over the depth planes (`GRUSweep`), then a softmax over
depth (training) or a winner-take-all (serving). In training mode
(`nn.Module.training`) the cost volume is differentiable (`CostVolumeFn`)
and the layers train (`models/layers.py`). With `cfg.refinement` the
3D-CNN graph builds a refinement network (`models/refine.py`) that
`refine` runs on the depth map and the reference image; the GRU graphs
ignore refinement, as JAX's do.
"""

from __future__ import annotations

import torch
from torch import nn

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.models.feature_net import UNetDS2GN
from mvsnet_tpu_torch.models.gru import GRURegularizer
from mvsnet_tpu_torch.models.layers import reset_parameters
from mvsnet_tpu_torch.models.refine import RefineNetConv, RefineUNetConv
from mvsnet_tpu_torch.models.regnet import RegNetUS0
from mvsnet_tpu_torch.ops import kernels
from mvsnet_tpu_torch.ops.cost_volume import plane_sweep_cost_volume
from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map, winner_take_all_update
from mvsnet_tpu_torch.ops.geometry import (depth_values, homographies_for_views,
                                           inv_depth_values)
from mvsnet_tpu_torch.ops.resize import resize_bilinear

REFINE_NETS = {"original": RefineNetConv, "unet": RefineUNetConv}


class GRUSweep(nn.Module):
    """The ConvGRU over the depth planes (`_GRUStep` and the `nn.scan` of
    `gru_cost_sweep`, mvsnet.py:50-68, :227-240), with the winner-take-all
    update of `forward_gru_wta` (:276-284) in the same step when the planes'
    depths are given.

    A depth step feeds the negated cost slice to the three cells from their
    float32 states, returns the float32 reg and, for serving, folds
    exp(reg) into the (max_prob, depth_image, exp_sum) carry. On the CPU and
    under autograd the planes run one by one in Python (`eager`). On a card
    in eval without autograd, JAX's compiled scan has its counterpart in a
    CUDA graph of one depth step (`graphed`), captured once per shape and
    replayed D times: a step is some 80 launches, and a 1600x1184 map at
    D=256 some 20,000."""

    MAX_GRAPHS = 4

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.network_mode = cfg.network_mode
        self.gru = GRURegularizer(cfg.feature_channels, cfg.network_mode, dtype=cfg.dtype)
        self._graphs = {}           # shape key -> _StepGraph, least recently used first
        self._graph_params = None   # the parameters' addresses the captures read

    def step(self, states, neg_cost, carry=None, depth=None):
        """(states, reg (B, h, w, 1) float32, carry or None) after one plane."""
        reg, states = self.gru(neg_cost, states)
        reg = reg.to(torch.float32)
        if carry is not None:
            carry = winner_take_all_update(carry, torch.exp(reg), depth)
        return states, reg, carry

    def forward(self, cost, samples=None):
        """cost (B, D, h, w, C); samples (B, D), each plane's depth, or None
        -> regs (B, D, h, w) float32, and the carry after the last plane
        (None without samples)."""
        if cost.device.type == "cuda" and not (self.training or torch.is_grad_enabled()):
            return self.graphed(cost, samples)
        return self.eager(cost, samples)

    def _zeros(self, cost):
        B, _, h, w, _ = cost.shape
        states = GRURegularizer.init_states(B, h, w, self.network_mode, device=cost.device)
        carry = tuple(torch.zeros((B, h, w, 1), dtype=torch.float32, device=cost.device)
                      for _ in range(3))
        return states, carry

    def eager(self, cost, samples=None):
        """The sweep plane by plane; see `forward`."""
        states, carry = self._zeros(cost)
        carry = None if samples is None else carry
        regs = []
        for d in range(cost.shape[1]):
            states, reg, carry = self.step(states, -cost[:, d], carry,
                                           None if samples is None else samples[:, d])
            regs.append(reg[..., 0])
        return torch.stack(regs, dim=1), carry

    def graphed(self, cost, samples=None):
        """The sweep as D replays of the captured step; see `forward`. One
        capture per shape, at most `MAX_GRAPHS` of them (the least recently
        used goes first); all are dropped when the parameters move (a load
        with `assign`, `.to()`), since a capture reads its buffers by
        address."""
        B, _, h, w, C = cost.shape
        key = (B, h, w, C, cost.dtype, cost.device, samples is not None,
               torch.is_inference_mode_enabled())
        params = tuple(p.data_ptr() for p in self.parameters())
        if params != self._graph_params:
            self._graphs.clear()
            self._graph_params = params
        graph = self._graphs.pop(key, None)
        if graph is None:
            while len(self._graphs) >= self.MAX_GRAPHS:
                del self._graphs[next(iter(self._graphs))]
            graph = _StepGraph(self, cost, samples is not None)
        self._graphs[key] = graph
        return graph.run(cost, samples)


class _StepGraph:
    """One eval depth step of a `GRUSweep` captured as a CUDA graph on
    static buffers (`kernels.CountedGraph`): the negated cost slice and the
    plane's depth go in, the cells' states and the winner-take-all carry
    stay in place, the reg comes out. Nothing falls back to the eager
    sweep."""

    def __init__(self, sweep: GRUSweep, cost, wta: bool):
        B, _, h, w, C = cost.shape
        dev = cost.device
        self.wta = wta
        self.neg_cost = torch.zeros((B, h, w, C), dtype=cost.dtype, device=dev)
        self.depth = torch.zeros((B,), dtype=torch.float32, device=dev)
        self.states, carry = sweep._zeros(cost)
        self.carry = carry if wta else None
        self.reg = torch.zeros((B, h, w), dtype=torch.float32, device=dev)

        def body():
            states, reg, carry = sweep.step(self.states, self.neg_cost, self.carry, self.depth)
            for dst, src in zip(self.states + (self.carry or ()), states + (carry or ())):
                dst.copy_(src)
            self.reg.copy_(reg[..., 0])

        self.graph = kernels.CountedGraph(body, dev)

    def run(self, cost, samples):
        B, D, h, w, _ = cost.shape
        for t in self.states + (self.carry or ()):
            t.zero_()
        regs = torch.empty((B, D, h, w), dtype=torch.float32, device=cost.device)
        for d in range(D):
            torch.neg(cost[:, d], out=self.neg_cost)
            if self.wta:
                self.depth.copy_(samples[:, d])
            self.graph.replay()
            regs[:, d].copy_(self.reg)
        return regs, (tuple(c.clone() for c in self.carry) if self.wta else None)


class MVSNet(nn.Module):
    """Feature tower + 3D U-Net (`regnet`, "3DCNN") or ConvGRU sweep
    (`gru_sweep`, "GRU"), and with refinement on the 3D-CNN graph the
    refinement network (`refine_net`, `cfg.refinement_network`), in eval
    mode until `.train()`. Weights are seeded with `seed` (lecun-normal
    kernels, identity norms) until a state dict from `convert.py` is
    loaded."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.feature_net = UNetDS2GN(cfg.network_mode, dtype=cfg.dtype)
        if cfg.regularization == "3DCNN":
            self.regnet = RegNetUS0(cfg.network_mode, cfg.feature_channels,
                                    dtype=cfg.dtype)
            if cfg.refinement:
                if cfg.refinement_network not in REFINE_NETS:
                    raise NotImplementedError(cfg.refinement_network)
                # the image, then the depth, the confidence and the stereo view
                data = 1 + cfg.refine_with_confidence + 3 * cfg.refine_with_stereo
                self.refine_net = REFINE_NETS[cfg.refinement_network](
                    3 + data, cfg.network_mode, dtype=cfg.dtype)
        elif cfg.regularization == "GRU":
            self.gru_sweep = GRUSweep(cfg)
        else:
            raise ValueError(f"unknown regularization {cfg.regularization!r}")
        reset_parameters(self, seed)
        # built for inference; `train_lib.create_train_state` (or `.train()`)
        # switches to training mode, with batch statistics and autograd convs
        self.eval()

    def extract_features(self, images):
        """(B, V, H, W, 3) -> ref (B, h, w, C), views (V-1, B, h, w, C)."""
        B, V, H, W, _ = images.shape
        feats = self.feature_net(images.reshape(B * V, H, W, 3))
        h, w, C = feats.shape[1:]
        feats = feats.reshape(B, V, h, w, C)
        return feats[:, 0], feats[:, 1:].movedim(1, 0)

    def depth_range(self, depth_start, depth_interval, B, device):
        """depth_start, depth_interval, depth_end as float32 (B,) tensors."""
        depth_start = torch.as_tensor(depth_start, dtype=torch.float32,
                                      device=device).expand(B)
        depth_interval = torch.as_tensor(depth_interval, dtype=torch.float32,
                                         device=device).expand(B)
        return depth_start, depth_interval, depth_start + (self.cfg.max_d - 1) * depth_interval

    def check_feature_shape(self, fh: int, fw: int) -> None:
        """RegNetUS0's three halvings must stay even: (D, h, w) % 8 == 0."""
        for dim, name in ((self.cfg.max_d, "max_d"), (fh, "feature height"),
                          (fw, "feature width")):
            if dim % 8 != 0:
                raise ValueError(
                    f"{name}={dim} must be divisible by 8 for the 3D U-Net "
                    f"regularizer (input H/W divisible by 32)")

    @property
    def refines(self) -> bool:
        """Whether the 3D-CNN graph ends in the refinement network."""
        return hasattr(self, "refine_net")

    def homographies(self, cams, depth_start, depth_interval, depth_end):
        """(V-1, B, D, 3, 3) float32 plane-sweep homographies."""
        return homographies_for_views(cams, self.cfg.max_d, depth_start, depth_interval,
                                      depth_end, inverse_depth=self.cfg.inverse_depth)

    def depth_tail(self, reg, depth_start, depth_interval, depth_end):
        """Regularized costs (B, D, h, w) float32 -> depth_map, prob_map."""
        cfg = self.cfg
        return soft_argmin_prob_map(reg, depth_start, depth_interval, cfg.max_d,
                                    inverse_depth=cfg.inverse_depth,
                                    depth_end=depth_end,
                                    num_buckets=cfg.prob_num_buckets)

    def forward_3dcnn(self, images, cams, depth_start, depth_interval):
        """images (B, V, H, W, 3), view 0 the reference; cams (B, V, 2, 4, 4)
        scaled to the cost-volume resolution; depth_start, depth_interval
        (B,). Returns depth_map, prob_map, each (B, h, w, 1) float32."""
        ds, di, de = self.depth_range(depth_start, depth_interval, images.shape[0],
                                      images.device)
        ref_f, view_f = self.extract_features(images)
        self.check_feature_shape(*ref_f.shape[1:3])
        cost = plane_sweep_cost_volume(ref_f, view_f, self.homographies(cams, ds, di, de),
                                       differentiable=self.training)
        reg = self.regnet(cost)[..., 0].to(torch.float32)          # (B, D, h, w)
        return self.depth_tail(reg, ds, di, de)

    forward = forward_3dcnn

    def gru_cost_sweep(self, images, cams, depth_start, depth_interval, depth_end,
                       samples=None):
        """The GRU sweep (mvsnet.py:193-240): features, the cost volume over
        all D planes at once (differentiable in training), then `GRUSweep`.
        depth_start, depth_interval, depth_end (B,) float32. Returns regs
        (B, D, h, w) float32 and the winner-take-all carry when `samples`
        (B, D) are given."""
        ref_f, view_f = self.extract_features(images)
        cost = plane_sweep_cost_volume(
            ref_f, view_f, self.homographies(cams, depth_start, depth_interval, depth_end),
            differentiable=self.training)
        return self.gru_sweep(cost, samples)

    def forward_prob_recurrent(self, images, cams, depth_start, depth_interval):
        """R-MVSNet's training graph (mvsnet.py:242-247): the float32
        softmax over depth of the GRU sweep's regs, (B, D, h, w)."""
        ds, di, de = self.depth_range(depth_start, depth_interval, images.shape[0],
                                      images.device)
        regs, _ = self.gru_cost_sweep(images, cams, ds, di, de)
        return torch.softmax(regs, dim=1)

    def forward_gru_wta(self, images, cams, depth_start, depth_interval=None, depth_end=None,
                        with_regs=False):
        """R-MVSNet's serving graph (mvsnet.py:249-285): the winner-take-all
        over the GRU sweep, prob = exp(reg). With `depth_end` the interval
        is (depth_end - depth_start) / (D - 1). Returns depth_map and
        prob_map = max_prob / sum_prob, each (B, h, w, 1) float32, and with
        `with_regs` the sweep's regs (B, D, h, w) too."""
        cfg, B, dev = self.cfg, images.shape[0], images.device
        if depth_end is None:
            ds, di, de = self.depth_range(depth_start, depth_interval, B, dev)
        else:
            ds = torch.as_tensor(depth_start, dtype=torch.float32, device=dev).expand(B)
            de = torch.as_tensor(depth_end, dtype=torch.float32, device=dev).expand(B)
            di = (de - ds) / (cfg.max_d - 1)
        samples = (inv_depth_values(ds, de, cfg.max_d) if cfg.inverse_depth
                   else depth_values(ds, di, cfg.max_d))
        regs, (max_prob, depth_image, exp_sum) = self.gru_cost_sweep(images, cams, ds, di, de,
                                                                     samples)
        out = (depth_image, max_prob / (exp_sum + 1e-7))
        return out + (regs,) if with_regs else out

    def refine(self, init_depth_map, image, prob_map, depth_start, depth_interval,
               stereo_image=None):
        """Depth refinement (mvsnet.py:287-336; reference: model.py:753-811).
        init_depth_map, prob_map (B, h, w, 1) float32; image, stereo_image
        (B, H, W, 3); depth_start, depth_interval (B,). The depth is
        normalised by (max_d - 1) * interval in float32; the net runs at the
        image's resolution with `upsample_before_refinement` (depth,
        normalised depth and confidence resized up), else at the depth's
        (images resized down). Returns (refined, residual), each at that
        resolution, float32; refined = residual + depth with
        `residual_refinement`, else the residual."""
        cfg = self.cfg
        B = init_depth_map.shape[0]
        ds, di, de = self.depth_range(depth_start, depth_interval, B, init_depth_map.device)
        scale = (de - ds)[:, None, None, None]
        norm_depth = (init_depth_map - ds[:, None, None, None]) / scale
        if cfg.upsample_before_refinement:
            H, W = image.shape[1:3]
            norm_depth = resize_bilinear(norm_depth, H, W)
            init_depth_map = resize_bilinear(init_depth_map, H, W)
            if cfg.refine_with_confidence:
                prob_map = resize_bilinear(prob_map, H, W)
        else:
            dh, dw = init_depth_map.shape[1:3]
            image = resize_bilinear(image, dh, dw)
            if stereo_image is not None:
                stereo_image = resize_bilinear(stereo_image, dh, dw)
        rh, rw = image.shape[1:3]
        if cfg.refinement_network == "unet" and (rh % 16 or rw % 16):
            raise ValueError(
                f"the refinement U-Net runs at {rh}x{rw} (height x width), and its four "
                f"stride-2 levels need both divisible by 16")
        if cfg.refine_with_stereo != (stereo_image is not None):
            raise ValueError("refine_with_stereo needs a stereo image, and only then takes one")
        data = [norm_depth]
        if cfg.refine_with_confidence:
            data.append(prob_map)
        if stereo_image is not None:
            data.append(stereo_image)
        residual = self.refine_net(image, torch.cat(data, dim=-1)).to(torch.float32) * scale
        refined = residual + init_depth_map if cfg.residual_refinement else residual
        return refined, residual


def refine_outputs(model: MVSNet, images, depth, prob, depth_start, depth_interval):
    """(refined, prob, residual) of the 3D-CNN graph's depth and prob
    (mvsnet.py:88-96): the reference view's image, and with
    `refine_with_stereo` the first source view's, through `model.refine`."""
    stereo = images[:, 1] if model.cfg.refine_with_stereo and images.shape[1] > 1 else None
    refined, residual = model.refine(depth, images[:, 0], prob, depth_start, depth_interval,
                                     stereo_image=stereo)
    return refined, prob, residual


def apply_forward_3dcnn(model: MVSNet, images, cams, depth_start, depth_interval):
    """Eval 3D-CNN forward (mvsnet.py:71-96): (depth, prob, residual), the
    residual zeros without refinement; with it (refined depth, prob,
    residual) from `refine_outputs`."""
    depth, prob = model.forward_3dcnn(images, cams, depth_start, depth_interval)
    if not model.refines:
        return depth, prob, torch.zeros_like(depth)
    return refine_outputs(model, images, depth, prob, depth_start, depth_interval)

