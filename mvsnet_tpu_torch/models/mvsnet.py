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
and the layers train (`models/layers.py`); the GRU's training sweep keeps
each plane's states, not its activations, and recomputes the depth steps
in the backward pass (`GRUSweep.remat`), and can take this rank's rows of
a map split over 'space' (`gru_cost_sweep`'s `blocks`). With
`cfg.refinement` the 3D-CNN graph builds a refinement network
(`models/refine.py`) that `refine` runs on the depth map and the reference
image; the GRU graphs ignore refinement, as JAX's do.

While a profiler records, the stages run inside `utils.profiling.span`
ranges: `mvsnet.features` (`extract_features`), and on one device
`mvsnet.cost_volume` (the homographies and K1), `mvsnet.regularizer` (the
U-Net or the sweep), `mvsnet.depth_tail` (the regs' cast and the
soft-argmin, or the winner-take-all's division) and `mvsnet.gru.capture`
(a new capture of the GRU's depth step).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.models.feature_net import UNetDS2GN, tower_split
from mvsnet_tpu_torch.models.gru import GRURegularizer
from mvsnet_tpu_torch.models.layers import reset_parameters
from mvsnet_tpu_torch.models.refine import RefineNetConv, RefineUNetConv
from mvsnet_tpu_torch.models.regnet import RegNetUS0
from mvsnet_tpu_torch.ops import kernels
from mvsnet_tpu_torch.ops.kernels import gru_step
from mvsnet_tpu_torch.ops.cost_volume import plane_sweep_cost_volume, sweep_cost_volume_sharded
from mvsnet_tpu_torch.ops.depth import soft_argmin_prob_map, winner_take_all_update
from mvsnet_tpu_torch.ops.geometry import (depth_values, homographies_for_views,
                                           inv_depth_values)
from mvsnet_tpu_torch.ops.resize import resize_bilinear
from mvsnet_tpu_torch.parallel.halo import halo_conv
from mvsnet_tpu_torch.parallel.mesh import AxisSplit
from mvsnet_tpu_torch.utils.profiling import span

REFINE_NETS = {"original": RefineNetConv, "unet": RefineUNetConv}


class GRUSweep(nn.Module):
    """The ConvGRU over the depth planes (`_GRUStep` and the `nn.scan` of
    `gru_cost_sweep`, mvsnet.py:50-68, :227-240), with the winner-take-all
    update of `forward_gru_wta` (:276-284) in the same step when the planes'
    depths are given.

    A depth step feeds the negated cost slice to the three cells from their
    float32 states, returns the float32 reg and, for serving, folds
    exp(reg) into the (max_prob, depth_image, exp_sum) carry. Whenever
    autograd records (training mode, or gradients on with a parameter or
    the volume that needs one) the sweep is JAX's `nn.scan(nn.remat(...))`
    (`remat`): it keeps each plane's float32 states and the cost volume,
    not the planes' activations, and recomputes one depth step at a time in
    the backward pass, so that its memory does not grow with D by more
    than the states. In eval on the CPU, or on a block of rows, the planes
    run one by one in Python (`eager`, also the tests' yardstick for
    `remat`). On a card in eval without autograd, JAX's compiled scan has
    its counterpart in a CUDA graph of one depth step (`graphed`), captured
    once per shape and replayed D times.

    Where the call allows it (`fuses`: a card, bf16, no autograd, the whole
    map, every cell norm a layer norm) `eager` and `graphed` run the fused
    step (`_FusedStep`): the 7 convs on persistent buffers and between them
    the 7 launches of `ops/kernels/gru_step`, about 17 launches a plane
    with the plane's slice, depth and reg moved in and out. Elsewhere the
    graph holds the plain step (`_PlainStep`), some 80 launches a plane."""

    MAX_GRAPHS = 4

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.network_mode = cfg.network_mode
        self.gru = GRURegularizer(cfg.feature_channels, cfg.network_mode, dtype=cfg.dtype)
        self._graphs = {}           # shape key -> _StepGraph, least recently used first
        self._graph_params = None   # the parameters' addresses the captures read

    def step(self, states, neg_cost, carry=None, depth=None, op=None, stat_sum=None):
        """(states, reg (B, h, w, 1) float32, carry or None) after one plane;
        `op` and `stat_sum` as in models/gru.py."""
        reg, states = self.gru(neg_cost, states, op, stat_sum)
        reg = reg.to(torch.float32)
        if carry is not None:
            carry = winner_take_all_update(carry, torch.exp(reg), depth)
        return states, reg, carry

    def forward(self, cost, samples=None, op=None, stat_sum=None):
        """cost (B, D, h, w, C); samples (B, D), each plane's depth, or None
        -> regs (B, D, h, w) float32, and the carry after the last plane
        (None without samples). `op` and `stat_sum`: a block of rows
        (models/gru.py)."""
        if self._records(cost):
            return self.remat(cost, samples, op, stat_sum)
        if cost.device.type == "cuda" and op is None:
            return self.graphed(cost, samples)
        return self.eager(cost, samples, op, stat_sum)

    def _records(self, cost) -> bool:
        """Whether autograd records the sweep: training mode, or gradients
        on with a parameter or the volume that needs one."""
        return self.training or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (cost, *self.parameters())))

    def fuses(self, cost, op=None, stat_sum=None) -> bool:
        """Whether a sweep of `cost` takes the fused step: a bf16 volume on a
        card, the whole map (no `op`, `stat_sum`) of at most
        `gru_step.MAX_BATCH` images, nothing that autograd records, and
        cells that it computes in the volume's dtype
        (`GRURegularizer.fusable`)."""
        return (cost.device.type == "cuda" and cost.dtype == torch.bfloat16 and op is None
                and stat_sum is None and cost.shape[0] <= gru_step.MAX_BATCH
                and not self._records(cost) and self.gru.fusable(cost.dtype))

    def _zeros(self, cost):
        B, _, h, w, _ = cost.shape
        states = GRURegularizer.init_states(B, h, w, self.network_mode, device=cost.device)
        carry = tuple(torch.zeros((B, h, w, 1), dtype=torch.float32, device=cost.device)
                      for _ in range(3))
        return states, carry

    def eager(self, cost, samples=None, op=None, stat_sum=None):
        """The sweep plane by plane; see `forward`. `op` and `stat_sum`: a
        block of rows (models/gru.py). Where `fuses`, the fused step's
        launches, uncaptured."""
        if self.fuses(cost, op, stat_sum):
            step = _FusedStep(self, cost, samples is not None)
            return step.sweep(cost, samples, step.body)
        states, carry = self._zeros(cost)
        carry = None if samples is None else carry
        regs = []
        for d, plane in enumerate(cost.unbind(1)):
            states, reg, carry = self.step(states, -plane, carry,
                                           None if samples is None else samples[:, d],
                                           op, stat_sum)
            regs.append(reg[..., 0])
        return torch.stack(regs, dim=1), carry

    def remat(self, cost, samples=None, op=None, stat_sum=None):
        """The sweep as JAX trains it (`nn.scan(nn.remat(_GRUStep))`,
        mvsnet.py:232-239): the planes run without autograd, keeping only
        the cost volume and each plane's float32 input states, and the
        backward recomputes one depth step at a time (`_RematSweep`). Regs
        and gradients equal `eager`'s bit for bit. With `samples` the
        winner-take-all carry folds the regs afterwards, as `step` folds
        them; see `forward`."""
        regs = _RematSweep.apply(self, op, stat_sum, cost, *self.parameters())
        if samples is None:
            return regs, None
        carry = self._zeros(cost)[1]
        for d, reg in enumerate(regs.unbind(1)):
            carry = winner_take_all_update(carry, torch.exp(reg[..., None]), samples[:, d])
        return regs, carry

    def graphed(self, cost, samples=None):
        """The sweep as D replays of the captured step (`_FusedStep` where
        `fuses`, else `_PlainStep`); see `forward`. One capture per shape,
        at most `MAX_GRAPHS` of them (the least recently used goes first);
        all are dropped when the parameters move (a load with `assign`,
        `.to()`), since a capture reads its buffers by address."""
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
            with span("mvsnet.gru.capture"):
                graph = _StepGraph(self, cost, samples is not None)
        self._graphs[key] = graph
        return graph.run(cost, samples)


class _RematSweep(torch.autograd.Function):
    """`GRUSweep.remat`: forward(sweep, op, stat_sum, cost, *the sweep's
    parameters) -> regs (B, D, h, w) float32.

    The forward runs the planes without autograd and saves the cost volume
    and the three states each plane starts from. The backward walks the
    planes from the last to the first: it recomputes the plane's step under
    autograd from its saved states and its cost slice (a view of the saved
    volume, negated inside the step) and differentiates that step alone,
    from the reg's gradient and, but for the last plane, the gradients of
    the states the next plane took. Autograd through the whole sweep sums
    in the same order: a state's gradients from the next plane come first,
    the ones from its own plane's later cells after them, and a parameter's
    from the last plane to the first. The halo exchanges and norm sums of a
    block of rows (`op`, `stat_sum`) run again in the recompute, in the same
    order on every rank."""

    @staticmethod
    def forward(ctx, sweep, op, stat_sum, cost, *params):
        B, D, h, w, _ = cost.shape
        states, _ = sweep._zeros(cost)
        regs = torch.empty((B, D, h, w), dtype=torch.float32, device=cost.device)
        saved = []
        for d, plane in enumerate(cost.unbind(1)):
            saved.extend(states)
            states, reg, _ = sweep.step(states, -plane, op=op, stat_sum=stat_sum)
            regs[:, d] = reg[..., 0]
        ctx.save_for_backward(cost, *saved)
        ctx.sweep, ctx.op, ctx.stat_sum, ctx.params = sweep, op, stat_sum, params
        return regs

    @staticmethod
    def backward(ctx, g_regs):
        cost, *saved = ctx.saved_tensors
        need_cost = ctx.needs_input_grad[3]
        wanted = ctx.needs_input_grad[4:]
        params = [p for p, need in zip(ctx.params, wanted) if need]
        g_cost = torch.empty_like(cost) if need_cost else None
        g_params = [None] * len(params)
        g_states = ()
        planes = cost.unbind(1)
        for d in reversed(range(cost.shape[1])):
            with torch.enable_grad():
                states = tuple(s.detach().requires_grad_(d > 0) for s in saved[3 * d:3 * d + 3])
                plane = planes[d].detach().requires_grad_(need_cost)
                new_states, reg, _ = ctx.sweep.step(states, -plane, op=ctx.op,
                                                    stat_sum=ctx.stat_sum)
            inputs = ([plane] if need_cost else []) + (list(states) if d > 0 else []) + params
            got = list(torch.autograd.grad(
                (reg,) + (new_states if g_states else ()), inputs,
                (g_regs[:, d, ..., None].contiguous(),) + g_states))
            if need_cost:
                g_cost[:, d] = got.pop(0)
            if d > 0:
                g_states, got = tuple(got[:3]), got[3:]
            g_params = [g if acc is None else acc + g for acc, g in zip(g_params, got)]
        taken = iter(g_params)
        return (None, None, None, g_cost) + tuple(next(taken) if need else None
                                                  for need in wanted)


class _Step:
    """Static buffers of one eval depth step (B, h, w) and the sweep over
    them: `neg_cost` takes the negated cost slice and `depth` the plane's
    depth, the states and the winner-take-all `carry` stay in place, `reg`
    holds the plane's float32 reg. `body()` runs the step on them."""

    def __init__(self, sweep: GRUSweep, cost, wta: bool):
        B, _, h, w, _ = cost.shape
        self.depth = torch.zeros((B,), dtype=torch.float32, device=cost.device)
        self.states, carry = sweep._zeros(cost)
        self.carry = carry if wta else None
        self.reg = torch.zeros((B, h, w), dtype=torch.float32, device=cost.device)

    def sweep(self, cost, samples, step):
        """regs (B, D, h, w) float32 and the carry after the last plane
        (None without samples), `step()` running one depth step: `body`,
        or a captured graph's replay."""
        B, D, h, w, _ = cost.shape
        self.reset()
        regs = torch.empty((B, D, h, w), dtype=torch.float32, device=cost.device)
        for d in range(D):
            torch.neg(cost[:, d], out=self.neg_cost)
            if self.carry is not None:
                self.depth.copy_(samples[:, d])
            step()
            regs[:, d].copy_(self.reg)
        return regs, (tuple(c.clone() for c in self.carry) if self.carry is not None else None)

    def reset(self):
        for t in self.states + (self.carry or ()):
            t.zero_()


class _PlainStep(_Step):
    """The step as `GRUSweep.step` computes it, its new states, carry and
    reg copied into the buffers."""

    def __init__(self, sweep: GRUSweep, cost, wta: bool):
        super().__init__(sweep, cost, wta)
        self.step = sweep.step
        self.neg_cost = torch.zeros(cost[:, 0].shape, dtype=cost.dtype, device=cost.device)

    def body(self):
        states, reg, carry = self.step(self.states, self.neg_cost, self.carry, self.depth)
        for dst, src in zip(self.states + (self.carry or ()), states + (carry or ())):
            dst.copy_(src)
        self.reg.copy_(reg[..., 0])


class _FusedStep(_Step):
    """The step on persistent buffers (`GRUSweep.fuses`), computed by
    `GRURegularizer.fused_step` (models/gru.py): cell 1's x, the first
    channels of its input, is the negated cost slice (`neg_cost`); the reg
    goes through the tail kernel (`gru_step.tail`: its float32 value, and
    the winner-take-all update of the carry in place). The convs' kernels
    are cast to the volume's dtype once a sweep, before its first plane, so
    that a load into the parameters in place reaches the next sweep. On the
    CPU the kernels' plain twin runs (the tests')."""

    def __init__(self, sweep: GRUSweep, cost, wta: bool):
        super().__init__(sweep, cost, wta)
        B, _, h, w, C = cost.shape
        self.gru = sweep.gru
        self.inputs, self.updates, self.prob_in = self.gru.fused_buffers(
            B, h, w, cost.dtype, cost.device)
        self.neg_cost = self.inputs[0][..., :C]
        self.kernels = [torch.empty(m.kernel.shape, dtype=cost.dtype, device=cost.device)
                        for m in self.gru.convs()]
        self.work = gru_step.workspace(B, h * w, cost.device)
        self.reset()

    def reset(self):
        super().reset()
        for t in self.inputs:
            t.zero_()
        for k, m in zip(self.kernels, self.gru.convs()):
            k.copy_(m.kernel)

    def body(self):
        reg = self.gru.fused_step(self.inputs, self.states, self.updates, self.prob_in,
                                  self.kernels, self.work)
        gru_step.tail(reg, self.reg, self.carry, self.depth)


class _StepGraph:
    """The body of a sweep's step (`_FusedStep` where `GRUSweep.fuses`, else
    `_PlainStep`) captured as a CUDA graph (`kernels.CountedGraph`),
    replayed once a plane. A sweep counts its steps' launches once. Nothing
    falls back to the eager sweep."""

    def __init__(self, sweep: GRUSweep, cost, wta: bool):
        self.step = (_FusedStep if sweep.fuses(cost) else _PlainStep)(sweep, cost, wta)
        self.graph = kernels.CountedGraph(self.step.body, cost.device)

    def run(self, cost, samples):
        out = self.step.sweep(cost, samples, self.graph.replay)
        self.graph.count(cost.shape[1])
        return out


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

    def extract_features(self, images, blocks=None):
        """(B, V, H, W, 3) -> ref (B, h, w, C), views (V-1, B, h, w, C).

        `blocks` (mesh, rows: a `parallel.mesh.AxisSplit` of the h feature
        rows over 'space'): this rank's rows [r0, r1) of both, (B, r1 - r0,
        w, C) and (V-1, B, r1 - r0, w, C), from the tower on the rank's
        image rows (`UNetDS2GN.forward_blocks`); where `feature_net.
        tower_split` finds the rows cannot split, from the whole tower,
        sliced."""
        with span("mvsnet.features"):
            B, V, H, W, _ = images.shape
            x = images.reshape(B * V, H, W, 3)
            if blocks is None:
                feats = self.feature_net(x)
            else:
                mesh, rows = blocks
                split = tower_split(mesh, rows, H)
                if split is None:
                    r0, r1 = rows.bounds()
                    feats = self.feature_net(x)[:, r0:r1]
                else:
                    feats = self.feature_net.forward_blocks(x, mesh, split)
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

    @property
    def maps_at_image_resolution(self) -> bool:
        """Whether `serve`'s maps come out at the images' resolution: with
        refinement after `upsample_before_refinement`. The drivers read the
        two flags for the GRU graph too, which ignores refinement, as JAX's
        do (mvsnet_tpu/infer.py:83)."""
        return self.cfg.refinement and self.cfg.upsample_before_refinement

    def serve(self, images, cams, depth_start, depth_interval, depth_end):
        """The serving call (`Predictor.predict`): (depth, prob, residual),
        each (B, h, w, 1) float32. As in JAX (mvsnet_tpu/predict.py:110-139)
        the 3D-CNN graph reads `depth_interval` and not `depth_end`
        (`apply_forward_3dcnn`: refined with refinement, else a zero
        residual), the GRU graph `depth_end` and not `depth_interval`
        (`forward_gru_wta`, a zero residual)."""
        if self.cfg.regularization == "GRU":
            depth, prob = self.forward_gru_wta(images, cams, depth_start, None, depth_end)
            return depth, prob, torch.zeros_like(depth)
        return apply_forward_3dcnn(self, images, cams, depth_start, depth_interval)

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
        with span("mvsnet.cost_volume"):
            cost = plane_sweep_cost_volume(ref_f, view_f, self.homographies(cams, ds, di, de),
                                           differentiable=self.training)
        with span("mvsnet.regularizer"):
            reg = self.regnet(cost)
        with span("mvsnet.depth_tail"):
            return self.depth_tail(reg[..., 0].to(torch.float32), ds, di, de)

    forward = forward_3dcnn

    def gru_cost_sweep(self, images, cams, depth_start, depth_interval, depth_end=None,
                       differentiable=None, *, samples=None, blocks=None):
        """The GRU sweep (mvsnet.py:193-240), with JAX's parameters in JAX's
        order: features, the cost volume over all D planes at once, then
        `GRUSweep`. depth_start, depth_interval, depth_end (B,) float32;
        `depth_end=None` is depth_start + (D - 1) * depth_interval, as in
        JAX. `differentiable` (JAX's) decides whether the cost volume is
        differentiable; None takes the module's mode (`self.training`).
        Returns regs (B, D, h, w) float32 and the winner-take-all carry
        when `samples` (B, D) are given, else None.

        `blocks` (mesh, rows: a `parallel.mesh.AxisSplit` over 'space'),
        for training over 'space' (JAX constrains the sweep's volume over
        'space', mvsnet.py:228): the tower runs on this rank's rows
        (`extract_features`' blocks), the cost volume is its rows over all
        D planes (D is the scan axis), K1s forward and K2/K3 on the block
        backward; the cells' 3x3 convs take a one-row halo over 'space' each
        plane and their norms sum their statistics over it. Regs are then
        (B, D, hl, w), the rank's rows."""
        if depth_end is None:
            depth_start, depth_interval, depth_end = self.depth_range(
                depth_start, depth_interval, images.shape[0], images.device)
        if differentiable is None:
            differentiable = self.training
        ref_f, view_f = self.extract_features(images, blocks)
        if blocks is None:
            with span("mvsnet.cost_volume"):
                cost = plane_sweep_cost_volume(
                    ref_f, view_f, self.homographies(cams, depth_start, depth_interval, depth_end),
                    differentiable=differentiable)
            with span("mvsnet.regularizer"):
                return self.gru_sweep(cost, samples)
        homs = self.homographies(cams, depth_start, depth_interval, depth_end)
        mesh, rows = blocks
        cost = sweep_cost_volume_sharded(ref_f, view_f, homs, mesh,
                                         depth=AxisSplit("depth", self.cfg.max_d), rows=rows)
        op = functools.partial(halo_conv, mesh=mesh, splits=(rows, None), level=0)
        return self.gru_sweep(cost, samples, op, lambda t: mesh.all_reduce_grad(t, rows.axis))

    def forward_prob_recurrent(self, images, cams, depth_start, depth_interval, blocks=None):
        """R-MVSNet's training graph (mvsnet.py:242-247): the float32
        softmax over depth of the GRU sweep's regs, (B, D, h, w); with
        `blocks` (see `gru_cost_sweep`) this rank's rows, (B, D, hl, w): the
        softmax is per pixel."""
        ds, di, de = self.depth_range(depth_start, depth_interval, images.shape[0],
                                      images.device)
        regs, _ = self.gru_cost_sweep(images, cams, ds, di, de, blocks=blocks)
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
                                                                     samples=samples)
        with span("mvsnet.depth_tail"):
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

