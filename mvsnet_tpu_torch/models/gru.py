"""Convolutional GRU cost regularizer of R-MVSNet (counterpart of
mvsnet_tpu/models/gru.py).

ConvGRUCell:
  gates:  conv(concat(x, h), 2f) -> split -> group norm -> sigmoid
  output: conv(concat(x, r * h), f) -> group norm -> tanh
  h' = u * h + (1 - u) * y
Both convs have biases. GRURegularizer stacks three cells (16, 4, 2 filters
in "normal" mode, halved otherwise) and a 1-channel 3x3 projection
`prob_conv`. The depth sweep lives in models/mvsnet.py (`GRUSweep`).

The fused step (`fused_step`, where `fusable`) computes the same depth step
on persistent buffers that `models/mvsnet._FusedStep` keeps: each cell one
channels-last input [x | slot] of in + f channels that both its convs read,
and between the convs the kernels of `ops/kernels/gru_step` (the gates
kernel writes (r * h) into the slot and keeps u; the output kernel writes
h' in float32 in place of the state and h' in the compute dtype into the
slot and into the next cell's x, or prob_conv's input). Its norms are the
twin's (`gru_step.layer_norm_plain`), whose statistics are float64 sums
where `GroupNormFlexible` takes float32 means.

With the rows of a map split over 'space' (multi-device training), `op`
replaces each conv's kernel call with the row-halo one
(`parallel/halo.halo_conv`) and `stat_sum` sums the norms' statistics
over the row blocks (`layers.GroupNormFlexible`).

Channels-last (B, H, W, C) only: the JAX package's channel-second-minor
"cw" layout is a TPU layout with the same numbers. The dtypes follow JAX's
promotion, which PyTorch's gives as long as no operand is cast early: the
hidden state is float32 and is cast to x's dtype only for the concats; the
convs and norms return the compute dtype; r * h and u * h promote to
float32, 1 - u stays in the compute dtype, so h' is float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mvsnet_tpu_torch.models.layers import Conv, GroupNormFlexible
from mvsnet_tpu_torch.ops.kernels import conv as conv_k
from mvsnet_tpu_torch.ops.kernels import gru_step


def _fused_conv(conv: Conv, x, kernel):
    """`conv` in eval on x, with its kernel already in x's dtype."""
    return conv_k.conv(x, kernel, conv.bias, conv.stride, relu=conv.relu)


def gru_filter_sizes(network_mode: str) -> Tuple[int, int, int]:
    """(16, 4, 2) in "normal" mode, halved otherwise (gru.py:25)."""
    div = 1 if network_mode == "normal" else 2
    return (16 // div, 4 // div, 2 // div)


class ConvGRUCell(nn.Module):
    """One ConvGRU cell (gru.py:31-58): forward(x, h) -> h'; `op` and
    `stat_sum` as in the module docstring."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cin = in_channels + filters
        self.gates_conv = Conv(cin, 2 * filters, kernel, 1, relu=False, use_bias=True,
                               dtype=dtype)
        self.reset_norm = GroupNormFlexible(filters)
        self.update_norm = GroupNormFlexible(filters)
        self.output_conv = Conv(cin, filters, kernel, 1, relu=False, use_bias=True,
                                dtype=dtype)
        self.output_norm = GroupNormFlexible(filters)

    def forward(self, x, h, op=None, stat_sum=None):
        gates = self.gates_conv(torch.cat([x, h.to(x.dtype)], dim=-1), op=op)
        reset, update = gates.chunk(2, dim=-1)
        reset = torch.sigmoid(self.reset_norm(reset, stat_sum))
        update = torch.sigmoid(self.update_norm(update, stat_sum))
        y = self.output_conv(torch.cat([x, (reset * h).to(x.dtype)], dim=-1), op=op)
        y = torch.tanh(self.output_norm(y, stat_sum))
        return update * h + (1 - update) * y

    def fusable(self, dtype) -> bool:
        """Whether `fused_step` computes this cell in `dtype`: both convs in
        it, and every norm a layer norm (G = 1) over a count of filters
        that the kernels are built for."""
        return (all(c.dtype in (None, dtype) for c in (self.gates_conv, self.output_conv))
                and all(n.groups == 1 and n.scale.numel() in gru_step.FILTERS
                        for n in (self.reset_norm, self.update_norm, self.output_norm)))

    def fused_step(self, inp, h, update, nxt, kernels, work=None):
        """`forward` on the fused step's buffers (module docstring): inp (B,
        H, W, in + f) = [x | slot] with the slot holding h in inp's dtype;
        h (B, H, W, f) float32, updated in place; update (B, H, W, f) in
        inp's dtype, scratch; nxt, whose first f channels take h'; kernels
        the two convs' kernels in inp's dtype; work a
        `gru_step.workspace`."""
        g = _fused_conv(self.gates_conv, inp, kernels[0])
        gru_step.gates(g, h, inp, update, self.reset_norm.scale, self.reset_norm.bias,
                       self.update_norm.scale, self.update_norm.bias, work)
        y = _fused_conv(self.output_conv, inp, kernels[1])
        gru_step.output(y, update, h, inp, nxt, self.output_norm.scale, self.output_norm.bias,
                        work)


class GRURegularizer(nn.Module):
    """One depth step of the three-cell stack and the projection
    (gru.py:61-84): forward(neg_cost, states) -> (reg (B, H, W, 1) in the
    compute dtype, new states), called with the negated cost slice."""

    def __init__(self, in_channels: int, network_mode: str = "normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f1, f2, f3 = gru_filter_sizes(network_mode)
        self.network_mode = network_mode
        self.conv_gru1 = ConvGRUCell(in_channels, f1, dtype=dtype)
        self.conv_gru2 = ConvGRUCell(f1, f2, dtype=dtype)
        self.conv_gru3 = ConvGRUCell(f2, f3, dtype=dtype)
        self.prob_conv = Conv(f3, 1, 3, 1, relu=False, use_bias=True, dtype=dtype)

    def forward(self, neg_cost, states: Sequence, op=None, stat_sum=None):
        s1 = self.conv_gru1(neg_cost, states[0], op, stat_sum)
        s2 = self.conv_gru2(s1, states[1], op, stat_sum)
        s3 = self.conv_gru3(s2, states[2], op, stat_sum)
        return self.prob_conv(s3, op=op), (s1, s2, s3)

    @property
    def cells(self):
        return (self.conv_gru1, self.conv_gru2, self.conv_gru3)

    def convs(self):
        """The convs in the order `fused_step` takes their kernels."""
        return [m for c in self.cells for m in (c.gates_conv, c.output_conv)] + [self.prob_conv]

    def fusable(self, dtype) -> bool:
        """Whether `fused_step` computes a depth step in `dtype`."""
        return all(c.fusable(dtype) for c in self.cells) and self.prob_conv.dtype in (None, dtype)

    def fused_buffers(self, batch: int, height: int, width: int, dtype, device):
        """The fused step's zero buffers: each cell's input [x | slot], its
        update, and prob_conv's input, in `dtype`."""
        def zeros(c):
            return torch.zeros((batch, height, width, c), dtype=dtype, device=device)
        return ([zeros(c.gates_conv.kernel.shape[-2]) for c in self.cells],
                [zeros(c.output_norm.scale.numel()) for c in self.cells],
                zeros(self.prob_conv.kernel.shape[-2]))

    def fused_step(self, inputs, states, updates, prob_in, kernels, work=None):
        """`forward` on the fused step's buffers (`fused_buffers`; the
        module docstring), inputs[0]'s first channels holding the negated
        cost slice: the states updated in place; returns the reg (B, H, W,
        1) in the buffers' dtype. kernels: `convs()`' kernels in that
        dtype."""
        for k, (cell, inp, h, u, nxt) in enumerate(zip(self.cells, inputs, states, updates,
                                                         inputs[1:] + [prob_in])):
            cell.fused_step(inp, h, u, nxt, kernels[2 * k:2 * k + 2], work)
        return _fused_conv(self.prob_conv, prob_in, kernels[-1])

    @staticmethod
    def init_states(batch: int, height: int, width: int, network_mode: str,
                    dtype=torch.float32, cw: bool = False, *, device=None):
        """Zero hidden states (B, H, W, f) for the three cells (gru.py:87),
        JAX's parameters in JAX's order; `cw=True` gives JAX's shape for its
        channel-second-minor layout, (B, H, f, W), which the port's cells
        do not take."""
        return tuple(torch.zeros((batch, height, f, width) if cw else
                                 (batch, height, width, f), dtype=dtype, device=device)
                     for f in gru_filter_sizes(network_mode))
