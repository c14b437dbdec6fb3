"""Convolutional GRU cost regularizer of R-MVSNet (counterpart of
mvsnet_tpu/models/gru.py).

ConvGRUCell:
  gates:  conv(concat(x, h), 2f) -> split -> group norm -> sigmoid
  output: conv(concat(x, r * h), f) -> group norm -> tanh
  h' = u * h + (1 - u) * y
Both convs have biases. GRURegularizer stacks three cells (16, 4, 2 filters
in "normal" mode, halved otherwise) and a 1-channel 3x3 projection
`prob_conv`. The depth sweep lives in models/mvsnet.py (`GRUSweep`).

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

    @staticmethod
    def init_states(batch: int, height: int, width: int, network_mode: str,
                    dtype=torch.float32, device=None):
        """Zero hidden states (B, H, W, f) for the three cells (gru.py:87)."""
        return tuple(torch.zeros((batch, height, width, f), dtype=dtype, device=device)
                     for f in gru_filter_sizes(network_mode))
