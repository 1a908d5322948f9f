"""Latent ODE right-hand sides: mechanistic SIR x neural hybrids.

Counterpart of ``fiude_tpu/models/rhs.py:48-163`` for the deterministic
families (the Bayes variants wait for ``ROADMAP.md``, queue A, "Bayes
families"):

* :class:`SIRRates` (Fp / CONN): rates ``|Fp_net(x)|`` give per-region
  (beta, gamma); ``dS=-beta*S*I, dI=beta*S*I-gamma*I, dR=gamma*I``.
* :class:`NeuralAug` (Fa / SONN): a free ELU field in the S, I, R slots.
* :class:`UDE` (FaFp / UONN): ``Fp + fa_w * Fa``; ``fa_w`` is a runtime
  float, the CONN->UONN transfer ramp.

Latent dims >= 3 get a zero derivative, and the derivative is zero wherever
the state is out of range, ``(x > 2) | (x < -1)`` (reference
``lib/models.py:130,144-145``).  ``forward(t, x[, fa_w]) -> (dx, aux)`` with
``x`` (batch, R, L) and ``aux`` holding the rates and/or the Fa field.

The rates net is named ``Fp_net`` in UONN as well as in CONN, so a CONN
checkpoint transfers its mechanistic net into a UONN (the JAX package's fix
of the reference, whose UONN calls it ``net``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fiude_tpu_torch.models.nn import elu_mlp


def out_of_range_mask(x: torch.Tensor) -> torch.Tensor:
    return (x > 2.0) | (x < -1.0)


def sir_field(rates: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mechanistic SIR derivative (..., R, 3) from positive rates (..., R, 2)."""
    plus_i = rates[..., 0] * x[..., 0] * x[..., 1]
    minus_i = rates[..., 1] * x[..., 1]
    return torch.stack([-plus_i, plus_i - minus_i, minus_i], dim=-1)


def _finish(field3: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the latent tail and freeze out-of-range states."""
    res = torch.cat([field3, torch.zeros_like(x[..., 3:])], dim=-1)
    return res.masked_fill(out_of_range_mask(x), 0.0)


class SIRRates(nn.Module):
    """CONN / "Fp": SIR with neural (beta, gamma)."""

    ode_type = "Fp"

    def __init__(self, n_regions: int = 1, latent_dim: int = 8,
                 net_sizes: Sequence[int] = (20, 20), *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_regions, self.latent_dim = n_regions, latent_dim
        self.Fp_net = elu_mlp([n_regions * latent_dim, *net_sizes, 2 * n_regions],
                              flatten=True, generator=generator, dtype=dtype)

    def forward(self, t, x: torch.Tensor):
        rates = self.Fp_net(x).abs().reshape(*x.shape[:-2], self.n_regions, 2)
        return _finish(sir_field(rates, x), x), {"rates": rates}


class NeuralAug(nn.Module):
    """SONN / "Fa": free neural augmentation in the S, I, R slots."""

    ode_type = "Fa"

    def __init__(self, n_regions: int = 1, latent_dim: int = 8,
                 aug_net_sizes: Sequence[int] = (32, 32), *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_regions, self.latent_dim = n_regions, latent_dim
        self.aug_net = elu_mlp(
            [n_regions * latent_dim, *aug_net_sizes, 3 * n_regions],
            flatten=True, generator=generator, dtype=dtype)

    def forward(self, t, x: torch.Tensor):
        fa = self.aug_net(x).reshape(*x.shape[:-2], self.n_regions, 3)
        return _finish(fa, x), {"fa": fa}


def empirical_rate_posterior(rates_aux: torch.Tensor, ddof: int = 1):
    """Empirical Normal over every collected (beta, gamma) evaluation:
    ``rates_aux`` (..., R, 2) flattened to (-1, 2), mean and (unbiased by
    default) std per column (``fiude_tpu/models/rhs.py:171-180``, reference
    ``lib/models.py:152-156``)."""
    flat = rates_aux.reshape(-1, 2)
    return flat.mean(dim=0), torch.std(flat, dim=0, correction=ddof)


class UDE(nn.Module):
    """UONN / "FaFp": mechanistic SIR-rates field + fa_w * neural field."""

    ode_type = "FaFp"

    def __init__(self, n_regions: int = 1, latent_dim: int = 8,
                 net_sizes: Sequence[int] = (20, 20),
                 aug_net_sizes: Sequence[int] = (32, 32), *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_regions, self.latent_dim = n_regions, latent_dim
        in_f = n_regions * latent_dim
        self.Fp_net = elu_mlp([in_f, *net_sizes, 2 * n_regions], flatten=True,
                              generator=generator, dtype=dtype)
        self.aug_net = elu_mlp([in_f, *aug_net_sizes, 3 * n_regions],
                               flatten=True, generator=generator, dtype=dtype)

    def forward(self, t, x: torch.Tensor, fa_w: float = 1.0):
        lead = x.shape[:-2]
        rates = self.Fp_net(x).abs().reshape(*lead, self.n_regions, 2)
        fa = self.aug_net(x).reshape(*lead, self.n_regions, 3)
        return (_finish(sir_field(rates, x) + fa_w * fa, x),
                {"rates": rates, "fa": fa})
