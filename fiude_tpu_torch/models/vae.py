"""The forecaster: variational encoder -> SIR latent UDE -> linear decoder.

Counterpart of ``fiude_tpu/models/vae.py`` (``reparam`` :37-51,
``UDEForecaster.build`` :103-181, ``sample_eps`` :195-199, ``apply``
:233-373) for the deterministic families::

    eps ~ N(0,1)^(S,B,R,Le)            Le = latent_dim - 1
    mean, std = encoder(x)
    z = reparam(eps, std, mean) + 1e-5   simplex R := 1 - |S| - |I|; fold S into B
    latent = odeint_grid(ode, z, t)      Kutta 3/8
    y = decoder(latent)                  -> (B, S, T, R)

:meth:`UDEForecaster.forward` is the plain twin of the whole serving path
that ``fiude_tpu_torch.ops.fused_ude.FusedForecaster`` runs through the two
CUDA kernels.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from fiude_tpu_torch.models.decoder import LinearDecoder
from fiude_tpu_torch.models.encoders import BackGRUEncoder
from fiude_tpu_torch.models.rhs import UDE, NeuralAug, SIRRates
from fiude_tpu_torch.ops.integrate import odeint_grid

_RHS = {"Fp": SIRRates, "CONN": SIRRates,
        "Fa": NeuralAug, "SONN": NeuralAug,
        "FaFp": UDE, "UONN": UDE}
_BAYES = ("Bayes_Fp", "CONNb", "Bayes_Fa", "SONNb", "Bayes_FaFp", "UONNb")


def reparam(eps: torch.Tensor, std: Optional[torch.Tensor], mean: torch.Tensor,
            *, uncertainty: bool = True) -> torch.Tensor:
    """Sample latent ICs and project (S, I) onto the SIR simplex.

    ``z = eps*std + mean``; ``z = [|z_S|, |z_I|, 1 - |z_S| - |z_I|, z_rest]``;
    the sample dim is folded into the batch as ``s*B + b``:
    (S, B, R, Le) -> (S*B, R, Le+1) (reference ``lib/models.py:16-24``).
    """
    z = eps * std + mean if uncertainty else mean.expand(eps.shape)
    head = z[..., :2].abs()
    r = 1.0 - head.sum(dim=-1, keepdim=True)
    z = torch.cat([head, r, z[..., 2:]], dim=-1)
    return z.reshape(z.shape[0] * z.shape[1], *z.shape[2:])


class ForwardExtras(NamedTuple):
    mean: torch.Tensor
    std: Optional[torch.Tensor]
    latent: torch.Tensor


class UDEForecaster(nn.Module):
    """Encoder / ODE / decoder stack (deterministic RHS families)."""

    def __init__(self, encoder: BackGRUEncoder, ode: nn.Module,
                 decoder: LinearDecoder, *, latent_dim: int = 8,
                 n_regions: int = 1, uncertainty: bool = True,
                 method: str = "rk4", ic_jitter: float = 1e-5):
        super().__init__()
        self.encoder, self.ode, self.decoder = encoder, ode, decoder
        self.latent_dim = latent_dim
        self.n_regions = n_regions
        self.uncertainty = uncertainty
        self.method = method
        self.ic_jitter = ic_jitter

    @classmethod
    def build(cls, *, n_regions: int, latent_dim: int, n_qs: int,
              ode_name: str = "FaFp", encoder_name: str = "back_gru",
              enc_params: Optional[Dict[str, Any]] = None,
              ode_params: Optional[Dict[str, Any]] = None,
              dec_params: Optional[Dict[str, Any]] = None,
              uncertainty: bool = True, dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None,
              device: Optional[torch.device] = None,
              fused_train: bool = False, **kwargs) -> "UDEForecaster":
        """Mirror of ``fiude_tpu``'s ``UDEForecaster.build`` (reference
        ``lib/VAE.py:36-89``) with one config dict per submodule.

        Weights are drawn on the CPU from ``generator`` (seed 0 when None),
        in the order encoder, ODE, decoder, then moved to ``device``: one
        seed gives the same model on every device.
        """
        if ode_name in _BAYES:
            raise NotImplementedError(
                f"{ode_name!r} is a Bayes family, not ported yet "
                "(ROADMAP.md, queue A, 'Bayes families')")
        if ode_name not in _RHS:
            raise ValueError(f"unknown ode_name {ode_name!r}")
        if encoder_name not in ("back_gru", "Encoder_Back_GRU"):
            raise NotImplementedError(
                f"encoder {encoder_name!r} is not ported yet "
                "(ROADMAP.md, queue A, 'Other encoders')")
        if fused_train:
            raise NotImplementedError(
                "fused_train needs the training kernels, not ported yet "
                "(ROADMAP.md, queue B)")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        enc_params = dict(enc_params or {})
        if "SIR_scaler" in enc_params:
            enc_params["sir_scaler"] = tuple(enc_params.pop("SIR_scaler"))
        rhs_cls = _RHS[ode_name]
        # the reference's RHS constructors take **kwargs and ignore extras
        # (lib/models.py:110,159,200): keep the sizes this family reads
        accepted = {SIRRates: ("net_sizes",), NeuralAug: ("aug_net_sizes",),
                    UDE: ("net_sizes", "aug_net_sizes")}[rhs_cls]
        ode_kw = {k: tuple(v) for k, v in (ode_params or {}).items()
                  if k in accepted}

        encoder = BackGRUEncoder(n_regions, n_qs=n_qs, latent_dim=latent_dim - 1,
                                 uncertainty=uncertainty, generator=generator,
                                 dtype=dtype, **enc_params)
        ode = rhs_cls(n_regions, latent_dim, generator=generator, dtype=dtype,
                      **ode_kw)
        decoder = LinearDecoder(n_regions, generator=generator, dtype=dtype,
                                **(dec_params or {}))
        model = cls(encoder, ode, decoder, latent_dim=latent_dim,
                    n_regions=n_regions, uncertainty=uncertainty, **kwargs)
        return model.to(device) if device is not None else model

    def sample_eps(self, batch_size: int, n_samples: int, *,
                   generator: torch.Generator,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(S, B, R, Le) standard-normal draws on ``generator``'s device."""
        return torch.randn(n_samples, batch_size, self.n_regions,
                           self.encoder.latent_dim, generator=generator,
                           dtype=dtype, device=generator.device)

    def rhs_fn(self, fa_w: float = 1.0):
        """Bind ``fa_w`` (read by the UDE only) into ``(t, y) -> (dy, aux)``."""
        if isinstance(self.ode, UDE):
            return lambda t, y: self.ode(t, y, fa_w=fa_w)
        return self.ode

    def forward(self, x: torch.Tensor, t, eps: torch.Tensor, *,
                fa_w: float = 1.0):
        """x: (B, T_in, F) window; t: (T,) grid; eps: (S, B, R, Le).

        Returns ``(y_pred (B, S, T, R), ForwardExtras)``.
        """
        n_samples, batch = eps.shape[0], eps.shape[1]
        mean, std = self.encoder(x)
        if not self.uncertainty:
            n_samples, eps = 1, eps[:1]
        z = reparam(eps, std, mean, uncertainty=self.uncertainty)
        z = z + self.ic_jitter
        latent = odeint_grid(self.rhs_fn(fa_w), z, t, method=self.method)
        y = self.decoder(latent)                               # (T, S*B, R)
        y = y.reshape(y.shape[0], n_samples, batch, self.n_regions)
        return y.permute(2, 1, 0, 3), ForwardExtras(mean, std, latent)
