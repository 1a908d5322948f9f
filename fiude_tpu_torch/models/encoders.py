"""Variational sequence encoders: surveillance window -> latent IC distribution.

Counterpart of ``fiude_tpu/models/encoders.py``, its four families:

* :class:`BackGRUEncoder` (``:49-128``; reference ``lib/models.py:53-107``),
  the live encoder: flip the window in time, run the stacked GRU, feed the
  last layer's final hidden state to a ReLU head, split the head into
  (mean, std) with ``std = |std| * sir_scaler``.  With ``fused_train`` and on
  the serving path it runs through the CUDA kernels K1/K3/K4;
* :class:`GenericEncoder` (``:141-195``), the legacy stack: the window
  optionally flipped, stacked GRUs read at the last step, a standard ReLU
  head (activated before its final projection too);
* :class:`BiGRUEncoder` and its alias :data:`MISOGRUEncoder` (``:198-268``):
  a bidirectional GRU stack over the queries beside a GRU stack over the ILI
  series with its last ``ili_trunc`` steps (the reporting lag) dropped, the
  two streams' last outputs into the reference-order ReLU head;
* :class:`BiLSTMEncoder` (``:273-314``): a bidirectional LSTM stack read at
  step ``read_offset`` = -14, one linear layer, output (B, 1, L) as the
  reference's (single region).

The JAX package runs the last three as ``lax.scan``s outside any Pallas
kernel, and so does this one: plain torch on both devices.  Submodules are
named after the JAX parameter tree (``grus``, ``ff``, ``i_layers``,
``q_layers``, ``layers``, ``fc``), whose ``keystr`` paths the checkpoints use
(``train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fiude_tpu_torch.models.nn import init_linear_, make_linear, relu_mlp, relu_mlp_standard
from fiude_tpu_torch.ops.gru import GRULayer, LSTMLayer, bigru, bilstm, gru, gru_stack_last


def sir_scaler_vector(sir_scaler: Sequence[float], latent_dim: int,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Extend the per-dim std scaler to ``latent_dim`` by repeating its last
    entry (reference ``lib/models.py:63-67``). Shape (1, latent_dim)."""
    s = list(sir_scaler)
    if latent_dim > len(s):
        s += [s[-1]] * (latent_dim - len(s))
    return torch.tensor(s[:latent_dim], dtype=dtype).reshape(1, -1)


def split_mean_std(h: torch.Tensor, n_regions: int, latent_dim: int,
                   scaler: torch.Tensor, uncertainty: bool):
    """Head output -> (mean, |std| * scaler), each (B, R, L); std is None
    without uncertainty (reference ``lib/models.py:98-104``)."""
    if not uncertainty:
        return h.reshape(-1, n_regions, latent_dim), None
    mean, std = h.chunk(2, dim=-1)
    mean = mean.reshape(-1, n_regions, latent_dim)
    std = std.reshape(-1, n_regions, latent_dim).abs() * scaler
    return mean, std


class _Encoder(nn.Module):
    """What every encoder family shares: the std scaler, a buffer (it moves
    with the module, is never trained and is absent from the state dict, as in
    the reference checkpoints), and the split of the head's output into
    (mean, |std| * scaler)."""

    def __init__(self, n_regions: int, latent_dim: int, uncertainty: bool,
                 sir_scaler: Sequence[float], dtype: Optional[torch.dtype]):
        super().__init__()
        self.n_regions = n_regions
        self.latent_dim = latent_dim
        self.uncertainty = uncertainty
        self.register_buffer("sir_scaler",
                             sir_scaler_vector(sir_scaler, latent_dim, dtype),
                             persistent=False)

    def split(self, h: torch.Tensor):
        return split_mean_std(h, self.n_regions, self.latent_dim,
                              self.sir_scaler, self.uncertainty)


def _gru_stack(sizes: Sequence[int], in_size: int, generator, dtype) -> nn.ModuleList:
    layers = nn.ModuleList()
    for h in sizes:
        layers.append(GRULayer(in_size, h, generator=generator, dtype=dtype))
        in_size = h
    return layers


class BackGRUEncoder(_Encoder):
    """Time-reversed stacked-GRU encoder (the live encoder).

    Submodules carry the reference's state-dict names: ``rnn_layers.{i}``
    (:class:`GRULayer`) and ``ff_layers`` (Linear, (ReLU, Linear)*, Linear).
    """

    def __init__(self, n_regions: int, *, n_qs: int = 9, latent_dim: int = 6,
                 q_sizes: Sequence[int] = (128, 64),
                 ff_sizes: Sequence[int] = (32,),
                 sir_scaler: Sequence[float] = (0.1, 0.05, 1.0),
                 uncertainty: bool = True,
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_regions, latent_dim, uncertainty, sir_scaler, dtype)
        self.n_qs = n_qs
        self.rnn_layers = _gru_stack(q_sizes, self.input_size, generator, dtype)
        self.ff_layers = relu_mlp([q_sizes[-1], *ff_sizes, self.out_features],
                                  generator=generator, dtype=dtype)

    @property
    def input_size(self) -> int:
        return self.n_regions * (self.n_qs + 1)

    @property
    def out_features(self) -> int:
        return (2 if self.uncertainty else 1) * self.n_regions * self.latent_dim

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, T, n_regions*(n_qs+1)) -> (mean, std) each (B, R, L)."""
        h = gru_stack_last(self.rnn_layers, torch.flip(x, dims=(1,)))
        return self.split(self.ff_layers(h))


class GenericEncoder(_Encoder):
    """The legacy generic encoder (reference ``lib/Old/old_models.py:9-39``):
    stacked GRUs over the window, flipped in time when ``reverse``, the last
    layer's final hidden state into a standard ReLU head whose last layer
    gives ``2 * R * L`` (with or without ``uncertainty``, as the reference's
    ``:13``)."""

    def __init__(self, rnn_input_size: int, n_regions: int, *, latent_dim: int = 6,
                 rnn_hidden_sizes: Sequence[int] = (64,),
                 ff_hidden_sizes: Sequence[int] = (32,),
                 sir_scaler: Sequence[float] = (0.1, 0.05, 1.0), reverse: bool = True,
                 uncertainty: bool = True, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_regions, latent_dim, uncertainty, sir_scaler, dtype)
        self.rnn_input_size = rnn_input_size
        self.reverse = reverse
        self.grus = _gru_stack(rnn_hidden_sizes, rnn_input_size, generator, dtype)
        self.ff = relu_mlp_standard(
            [rnn_hidden_sizes[-1], *ff_hidden_sizes, 2 * n_regions * latent_dim],
            generator=generator, dtype=dtype)

    @property
    def input_size(self) -> int:
        return self.rnn_input_size

    def forward(self, x: torch.Tensor):
        """x: (B, T, rnn_input_size) -> (mean, std) each (B, R, L)."""
        if self.reverse:
            x = torch.flip(x, dims=(1,))
        return self.split(self.ff(gru_stack_last(self.grus, x)))


class BiGRUEncoder(_Encoder):
    """Two streams (reference ``lib/Old/old_models.py:372-435``): a stack of
    bidirectional GRUs over the queries, ``x[..., :-R]``, and a stack of GRUs
    over the ILI series, ``x[:, :-ili_trunc, -R:]`` (the last ``ili_trunc``
    steps dropped before the recurrence); the ILI stream's and the queries'
    last outputs, in that order, into the reference-order ReLU head."""

    def __init__(self, n_regions: int, *, n_qs: int = 10, latent_dim: int = 6,
                 q_sizes: Sequence[int] = (128, 64), ili_sizes: Sequence[int] = (32, 16),
                 ff_sizes: Sequence[int] = (64, 32),
                 sir_scaler: Sequence[float] = (0.1, 0.05, 1.0), ili_trunc: int = 14,
                 uncertainty: bool = True, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_regions, latent_dim, uncertainty, sir_scaler, dtype)
        self.n_qs = n_qs
        self.ili_trunc = ili_trunc
        self.i_layers = _gru_stack(ili_sizes, n_regions, generator, dtype)
        self.q_layers = nn.ModuleList()
        in_size = n_regions * n_qs
        for h in q_sizes:
            self.q_layers.append(nn.ModuleList(
                GRULayer(in_size, h, generator=generator, dtype=dtype) for _ in range(2)))
            in_size = 2 * h
        out = (2 if uncertainty else 1) * n_regions * latent_dim
        self.ff = relu_mlp([2 * q_sizes[-1] + ili_sizes[-1], *ff_sizes, out],
                           generator=generator, dtype=dtype)

    @property
    def input_size(self) -> int:
        return self.n_regions * (self.n_qs + 1)

    def forward(self, x: torch.Tensor):
        """x: (B, T, R*(n_qs+1)), the queries then the ILI series -> (mean,
        std) each (B, R, L)."""
        x_qs = x[:, :, :-self.n_regions]
        x_ili = x[:, :-self.ili_trunc, -self.n_regions:]
        for g in self.i_layers:
            x_ili, _ = gru(g, x_ili)
        for fwd, bwd in self.q_layers:
            x_qs, _ = bigru(fwd, bwd, x_qs)
        h = torch.cat([x_ili[:, -1], x_qs[:, -1]], dim=-1)
        return self.split(self.ff(h))


#: MISO-GRU has the BiGRU encoder's topology in the reference
#: (``lib/Old/old_models.py:319-370`` against ``:372-435`` differ only in name).
MISOGRUEncoder = BiGRUEncoder


class BiLSTMEncoder(_Encoder):
    """Bidirectional LSTM stack read at step ``read_offset`` (reference
    ``tuning/tune_node.py:25-61``, single region there and here), one linear
    layer to ``2 * L``; returns (mean, std) each (B, 1, L), whatever
    ``n_regions`` and ``uncertainty``, as the reference does."""

    def __init__(self, input_size: int, hidden_size: int, *, num_layers: int = 1,
                 latent_dim: int = 6, n_regions: int = 1,
                 sir_scaler: Sequence[float] = (0.1, 0.05, 1.0), read_offset: int = -14,
                 uncertainty: bool = True, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_regions, latent_dim, uncertainty, sir_scaler, dtype)
        self.input_size = input_size
        self.read_offset = read_offset
        self.layers = nn.ModuleList()
        in_size = input_size
        for _ in range(num_layers):
            self.layers.append(nn.ModuleList(
                LSTMLayer(in_size, hidden_size, generator=generator, dtype=dtype)
                for _ in range(2)))
            in_size = 2 * hidden_size
        self.fc = make_linear(2 * hidden_size, 2 * latent_dim, dtype=dtype)
        init_linear_(self.fc, generator)

    def forward(self, x: torch.Tensor):
        for fwd, bwd in self.layers:
            x, _ = bilstm(fwd, bwd, x)
        mean, std = self.fc(x[:, self.read_offset]).chunk(2, dim=-1)
        return mean[:, None], (std.abs() * self.sir_scaler)[:, None]
