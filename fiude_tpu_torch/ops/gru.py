"""GRU recurrence in plain torch ops, with torch's gate conventions.

Counterpart of ``fiude_tpu/ops/gru.py:72-140`` (``gru_cell``,
``gru_stack_last``).  Gate order is torch's r|z|n::

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh  (W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

:class:`GRULayer` holds one layer's weights under the names of a one-layer
``torch.nn.GRU`` (``weight_ih_l0`` (3H, I), ...), so a Back-GRU encoder's
state dict reads ``rnn_layers.{i}.weight_ih_l0`` like the reference's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class GRULayer(nn.Module):
    """One GRU layer's parameters, torch layout (out, in)."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        h3 = 3 * hidden_size
        k = 1.0 / math.sqrt(hidden_size)   # torch default: U(-1/sqrt(H), 1/sqrt(H))

        def param(*shape):
            t = torch.empty(shape, dtype=dtype)
            t.uniform_(-k, k, generator=generator)
            return nn.Parameter(t)

        self.weight_ih_l0 = param(h3, input_size)
        self.weight_hh_l0 = param(h3, hidden_size)
        self.bias_ih_l0 = param(h3)
        self.bias_hh_l0 = param(h3)

    def input_projection(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W_ih^T + b_ih`` over any leading dims."""
        return x @ self.weight_ih_l0.T + self.bias_ih_l0


def gru_gates(x_proj: torch.Tensor, h_proj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """New hidden state from both projections (each r|z|n, biases included)."""
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_cell(layer: GRULayer, h: torch.Tensor, x_proj: torch.Tensor) -> torch.Tensor:
    """One GRU step given the precomputed input projection ``x @ W_ih^T + b_ih``."""
    return gru_gates(x_proj, h @ layer.weight_hh_l0.T + layer.bias_hh_l0, h)


def gru_stack_last(layers: Sequence[GRULayer], x: torch.Tensor) -> torch.Tensor:
    """Stacked GRU sweep over ``x`` (B, T, I): the LAST layer's FINAL hidden state.

    Layer 0's input projection for all steps is one hoisted matmul; every
    layer advances inside one time step, as ``fiude_tpu/ops/gru.py:114-140``.
    """
    batch, seq, _ = x.shape
    hs = [x.new_zeros(batch, layer.hidden_size) for layer in layers]
    x_proj = layers[0].input_projection(x)          # (B, T, 3H0)
    for t in range(seq):
        hs[0] = gru_cell(layers[0], hs[0], x_proj[:, t])
        for l in range(1, len(layers)):
            hs[l] = gru_cell(layers[l], hs[l],
                             layers[l].input_projection(hs[l - 1]))
    return hs[-1]
