"""Variational Back-GRU encoder: surveillance window -> latent IC distribution.

Counterpart of ``fiude_tpu/models/encoders.py:49-128`` (``BackGRUEncoder``,
``sir_scaler_vector``, ``_split_mean_std``); reference ``lib/models.py:53-107``.
Flip the window in time, run the stacked GRU, feed the last layer's final
hidden state to a ReLU head, split the head into (mean, std) with
``std = |std| * sir_scaler``.  The other encoder families wait for a later
slice of the port (``ROADMAP.md``, queue A, "Other encoders").
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fiude_tpu_torch.models.nn import relu_mlp
from fiude_tpu_torch.ops.gru import GRULayer, gru_stack_last


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


class BackGRUEncoder(nn.Module):
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
        super().__init__()
        self.n_regions = n_regions
        self.n_qs = n_qs
        self.latent_dim = latent_dim
        self.uncertainty = uncertainty
        self.rnn_layers = nn.ModuleList()
        in_size = self.input_size
        for h in q_sizes:
            self.rnn_layers.append(GRULayer(in_size, h, generator=generator,
                                            dtype=dtype))
            in_size = h
        self.ff_layers = relu_mlp([q_sizes[-1], *ff_sizes, self.out_features],
                                  generator=generator, dtype=dtype)
        # a buffer, not a parameter: moves with the module, never trained,
        # and absent from the state dict as in the reference checkpoints
        self.register_buffer("sir_scaler",
                             sir_scaler_vector(sir_scaler, latent_dim, dtype),
                             persistent=False)

    @property
    def input_size(self) -> int:
        return self.n_regions * (self.n_qs + 1)

    @property
    def out_features(self) -> int:
        return (2 if self.uncertainty else 1) * self.n_regions * self.latent_dim

    def split(self, h: torch.Tensor):
        return split_mean_std(h, self.n_regions, self.latent_dim,
                              self.sir_scaler, self.uncertainty)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, T, n_regions*(n_qs+1)) -> (mean, std) each (B, R, L)."""
        h = gru_stack_last(self.rnn_layers, torch.flip(x, dims=(1,)))
        return self.split(self.ff_layers(h))
