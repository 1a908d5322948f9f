"""GRU and LSTM recurrences in plain torch ops, with torch's gate conventions.

Counterpart of ``fiude_tpu/ops/gru.py:72-194`` (``gru_cell``, ``gru``,
``gru_stack_last``, ``bigru``, ``lstm_cell``, ``lstm``, ``bilstm``).  GRU
gate order is torch's r|z|n::

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh  (W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

and LSTM gate order torch's i|f|g|o::

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

:class:`GRULayer` and :class:`LSTMLayer` hold one layer's weights under the
names of a one-layer ``torch.nn.GRU`` / ``torch.nn.LSTM`` (``weight_ih_l0``
(3H or 4H, I), ...), so a Back-GRU encoder's state dict reads
``rnn_layers.{i}.weight_ih_l0`` like the reference's.  Each sequence's input
projection is one matmul hoisted out of the time loop, as the JAX package's
is; the loop is plain torch, never ``nn.GRU``/``nn.LSTM`` (cuDNN), so the CPU
and the card run one code path and the gradients are repeatable.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class RecurrentLayer(nn.Module):
    """One recurrent layer's parameters, torch layout (out, in): ``gates``
    blocks of H rows in each matrix and bias."""

    gates: int

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        width = self.gates * hidden_size
        k = 1.0 / math.sqrt(hidden_size)   # torch default: U(-1/sqrt(H), 1/sqrt(H))

        def param(*shape):
            t = torch.empty(shape, dtype=dtype)
            t.uniform_(-k, k, generator=generator)
            return nn.Parameter(t)

        self.weight_ih_l0 = param(width, input_size)
        self.weight_hh_l0 = param(width, hidden_size)
        self.bias_ih_l0 = param(width)
        self.bias_hh_l0 = param(width)

    def input_projection(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W_ih^T + b_ih`` over any leading dims."""
        return x @ self.weight_ih_l0.T + self.bias_ih_l0

    def hidden_projection(self, h: torch.Tensor) -> torch.Tensor:
        """``h @ W_hh^T + b_hh``: a step's recurrent projection."""
        return h @ self.weight_hh_l0.T + self.bias_hh_l0


class GRULayer(RecurrentLayer):
    """One GRU layer: ``weight_ih_l0`` (3H, I), ``weight_hh_l0`` (3H, H),
    ``bias_ih_l0``, ``bias_hh_l0`` (3H,), gates r|z|n."""

    gates = 3


class LSTMLayer(RecurrentLayer):
    """One LSTM layer: ``weight_ih_l0`` (4H, I), ``weight_hh_l0`` (4H, H),
    ``bias_ih_l0``, ``bias_hh_l0`` (4H,), gates i|f|g|o."""

    gates = 4


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
    return gru_gates(x_proj, layer.hidden_projection(h), h)


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


def _sequence(cell, layer, x: torch.Tensor, carry, reverse: bool):
    """Run ``cell(layer, carry, x_proj_t) -> carry`` over (B, T, I) from either
    end: outputs (B, T, H) in the input's time order, and the last carry."""
    x_proj = layer.input_projection(x)              # (B, T, gates * H)
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    outs = [None] * x.shape[1]
    for t in steps:
        carry = cell(layer, carry, x_proj[:, t])
        outs[t] = carry[0] if isinstance(carry, tuple) else carry
    return torch.stack(outs, dim=1), carry


def gru(layer: GRULayer, x: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
        reverse: bool = False):
    """A GRU over ``x`` (B, T, I): ``(outputs (B, T, H), h_T)``.  ``reverse``
    sweeps right to left and returns the outputs in the original time order
    (torch's ``bidirectional`` convention); ``h_T`` is then the state after
    step 0 (``fiude_tpu/ops/gru.py:84-112``)."""
    if h0 is None:
        h0 = x.new_zeros(x.shape[0], layer.hidden_size)
    return _sequence(gru_cell, layer, x, h0, reverse)


def bigru(fwd: GRULayer, bwd: GRULayer, x: torch.Tensor):
    """Bidirectional GRU: ``(concat of both outputs (B, T, 2H), (h_f, h_b))``."""
    out_f, h_f = gru(fwd, x)
    out_b, h_b = gru(bwd, x, reverse=True)
    return torch.cat([out_f, out_b], dim=-1), (h_f, h_b)


def lstm_cell(layer: LSTMLayer, carry, x_proj: torch.Tensor):
    """One LSTM step ``(h, c) -> (h', c')`` given the precomputed input
    projection ``x @ W_ih^T + b_ih``."""
    h, c = carry
    i, f, g, o = (x_proj + layer.hidden_projection(h)).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm(layer: LSTMLayer, x: torch.Tensor, carry0=None, *, reverse: bool = False):
    """An LSTM over ``x`` (B, T, I): ``(outputs (B, T, H), (h_T, c_T))``."""
    if carry0 is None:
        zeros = x.new_zeros(x.shape[0], layer.hidden_size)
        carry0 = (zeros, zeros)
    return _sequence(lstm_cell, layer, x, carry0, reverse)


def bilstm(fwd: LSTMLayer, bwd: LSTMLayer, x: torch.Tensor):
    """Bidirectional LSTM: ``(concat of both outputs (B, T, 2H), (carry_f,
    carry_b))``."""
    out_f, cf = lstm(fwd, x)
    out_b, cb = lstm(bwd, x, reverse=True)
    return torch.cat([out_f, out_b], dim=-1), (cf, cb)
