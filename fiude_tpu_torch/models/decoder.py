"""Linear decoder: latent S, I, R block -> per-region ILI readout.

Counterpart of ``LinearDecoder`` in ``fiude_tpu/models/decoder.py:19-42``
(reference ``lib/models.py:26-51``): reads latent dims ``[:3]``, flattens
them region-major (r*3 + c) and applies one linear map 3R -> R, initialised
N(0, 0.1^2) with zero bias.  ``decoder`` is ``Sequential(Flatten, Linear)``,
so the state-dict keys are the reference's ``decoder.1.weight/bias``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fiude_tpu_torch.models.nn import init_linear_normal_, make_linear


class LinearDecoder(nn.Module):
    read_dims = 3

    def __init__(self, n_regions: int, input_dim: int = 1, *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_regions = n_regions
        linear = make_linear(n_regions * self.read_dims, n_regions * input_dim,
                             dtype=dtype)
        init_linear_normal_(linear, generator, std=0.1)
        self.decoder = nn.Sequential(nn.Flatten(-2), linear)

    @property
    def linear(self) -> nn.Linear:
        return self.decoder[1]

    def forward(self, data: torch.Tensor) -> torch.Tensor:
        """data: (..., R, >=3) -> (..., R*input_dim)."""
        return self.decoder(data[..., : self.read_dims])
