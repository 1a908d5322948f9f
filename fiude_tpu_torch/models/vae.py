"""The forecaster: variational encoder -> SIR latent UDE -> linear decoder.

Counterpart of ``fiude_tpu/models/vae.py`` (``reparam`` :37-51,
``make_prior`` :54-68, ``UDEForecaster.build`` :103-181, ``sample_eps``
:195-199, ``_encode`` :217-231, ``apply`` :233-373) for the deterministic
families::

    eps ~ N(0,1)^(S,B,R,Le)            Le = latent_dim - 1
    mean, std = encoder(x)
    z = reparam(eps, std, mean) + 1e-5   simplex R := 1 - |S| - |I|; fold S into B
    latent, aux = odeint_grid(ode, z, t) Kutta 3/8, stage-ordered aux
    y = decoder(latent)                  -> (B, S, T, R)

:meth:`UDEForecaster.forward` is the plain twin of the whole serving path
that ``fiude_tpu_torch.ops.fused_ude.FusedForecaster`` runs through the two
CUDA kernels.  With ``fused_train`` (and ``fused_stats``, which the
production sweeps always set with it) the same forward is the training
path: the encoder runs through K3/K4 (``ops.fused_gru_train``) and the
trajectory through K5/K6 (``ops.fused_train``), which reduce the loss's aux
to five masked sums on the card.
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


def make_prior(mean: torch.Tensor, *, latent_dim: int, z_prior=(0.1, 0.01)):
    """Latent IC prior: S, I anchored at the encoder mean with tight stds,
    the other dims standard normal (reference ``lib/models.py:9-14``).
    Returns ``(prior_mean, prior_std)`` shaped like ``mean``."""
    prior_mean = torch.cat([mean[..., :2], torch.zeros_like(mean[..., 2:])], dim=-1)
    std = torch.cat([torch.tensor(z_prior, dtype=mean.dtype, device=mean.device),
                     torch.ones(latent_dim - len(z_prior) - 1, dtype=mean.dtype,
                                device=mean.device)])
    return prior_mean, torch.abs(std).expand(prior_mean.shape)


class ForwardExtras(NamedTuple):
    mean: torch.Tensor
    std: Optional[torch.Tensor]
    latent: torch.Tensor
    aux: Any = None
    """the stage-ordered RHS aux {"rates", "fa"} (T-1, 4, B, R, k), or with
    ``fused_stats`` {"rate_stats": (r1, r2, count), "fa_sq": f2}"""


class UDEForecaster(nn.Module):
    """Encoder / ODE / decoder stack (deterministic RHS families)."""

    def __init__(self, encoder: BackGRUEncoder, ode: nn.Module,
                 decoder: LinearDecoder, *, latent_dim: int = 8,
                 n_regions: int = 1, uncertainty: bool = True,
                 method: str = "rk4", substeps: int = 1, ic_jitter: float = 1e-5,
                 fused_train: bool = False, fused_stats: bool = False):
        super().__init__()
        if fused_train and not fused_stats:
            raise NotImplementedError(
                "fused_train without fused_stats (the aux-streaming K5/K6 mode) is "
                "not ported yet (ROADMAP.md, queue B, 'K5/K6 aux-streaming mode')")
        if fused_train and (method not in ("rk4", "rk4_38") or substeps != 1):
            raise NotImplementedError(
                "fused_train integrates with one Kutta 3/8 step an interval; other "
                "methods and substeps are not ported yet (ROADMAP.md, queue A, "
                "'Other solvers')")
        self.encoder, self.ode, self.decoder = encoder, ode, decoder
        self.latent_dim = latent_dim
        self.n_regions = n_regions
        self.uncertainty = uncertainty
        self.method = method
        self.substeps = substeps
        self.ic_jitter = ic_jitter
        self.fused_train = fused_train
        self.fused_stats = fused_stats

    @classmethod
    def build(cls, *, n_regions: int, latent_dim: int, n_qs: int,
              ode_name: str = "FaFp", encoder_name: str = "back_gru",
              enc_params: Optional[Dict[str, Any]] = None,
              ode_params: Optional[Dict[str, Any]] = None,
              dec_params: Optional[Dict[str, Any]] = None,
              uncertainty: bool = True, dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None,
              device: Optional[torch.device] = None,
              **kwargs) -> "UDEForecaster":
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

    def _encode(self, x: torch.Tensor):
        """Encoder forward ``x -> (mean, std)``; with ``fused_train`` a
        Back-GRU encoder runs through K3/K4 on the card (no VMEM guard: on a
        CUDA tensor the kernels run or raise)."""
        if self.fused_train and isinstance(self.encoder, BackGRUEncoder):
            from fiude_tpu_torch.ops.fused_gru_train import encode_train  # ops import models
            return encode_train(x, self.encoder)
        return self.encoder(x)

    def _fused_trajectory(self, z: torch.Tensor, t, fa_w, time_mask):
        """K5/K6 in stats mode: the latent trajectory and the stats aux
        (``fiude_tpu/models/vae.py:292-357``)."""
        from fiude_tpu_torch.ops.fused_train import train_trajectory, traj_to_model_layout
        from fiude_tpu_torch.ops.fused_ude import pack_field
        batch, n_regions, latent_dim = z.shape
        grid = torch.as_tensor(t).detach().to("cpu", torch.float64)
        dts = (grid[1:] - grid[:-1]).to(z.device, z.dtype)
        if time_mask is None:
            tmask = torch.ones_like(dts)
        else:
            tmask = torch.as_tensor(time_mask).to(z.device, z.dtype)
        tail = z[..., 3:].reshape(batch, -1)
        w = pack_field(self.ode, detach=False)
        traj, r1, r2, f2 = train_trajectory(z[..., :3].reshape(batch, -1), tail, w,
                                            fa_w=fa_w, dts=dts, tmask=tmask)
        latent = traj_to_model_layout(traj, tail, n_regions, latent_dim)
        aux = {}
        if w.n0_fp:
            aux["rate_stats"] = (r1, r2, 4.0 * batch * n_regions * tmask.sum())
        if w.aug:
            aux["fa_sq"] = f2
        return latent, aux

    def forward(self, x: torch.Tensor, t, eps: torch.Tensor, *,
                fa_w: float = 1.0, time_mask=None):
        """x: (B, T_in, F) window; t: (T,) grid; eps: (S, B, R, Le);
        ``time_mask``: optional (T-1,) per-interval loss weights of the padded
        curriculum, read only by the fused stats path (every other path
        applies it in the loss).

        Returns ``(y_pred (B, S, T, R), ForwardExtras)``.
        """
        n_samples, batch = eps.shape[0], eps.shape[1]
        mean, std = self._encode(x)
        if not self.uncertainty:
            n_samples, eps = 1, eps[:1]
        z = reparam(eps, std, mean, uncertainty=self.uncertainty)
        z = z + self.ic_jitter
        if self.fused_train:
            latent, aux = self._fused_trajectory(z, t, fa_w, time_mask)
        else:
            latent, aux = odeint_grid(self.rhs_fn(fa_w), z, t, method=self.method,
                                      substeps=self.substeps)
        y = self.decoder(latent)                               # (T, S*B, R)
        y = y.reshape(y.shape[0], n_samples, batch, self.n_regions)
        return y.permute(2, 1, 0, 3), ForwardExtras(mean, std, latent, aux)
