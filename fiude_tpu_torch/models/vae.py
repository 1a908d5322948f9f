"""The forecaster: variational encoder -> SIR latent UDE -> linear decoder.

Counterpart of ``fiude_tpu/models/vae.py`` (``reparam`` :37-51,
``make_prior`` :54-68, ``UDEForecaster.build`` :103-181, ``sample_eps``
:195-199, ``_encode`` :217-231, ``apply`` :233-373)::

    eps ~ N(0,1)^(S,B,R,Le)            Le = latent_dim - 1
    mean, std = encoder(x)
    z = reparam(eps, std, mean) + 1e-5   simplex R := 1 - |S| - |I|; fold S into B
    latent, aux = odeint_grid(ode, z, t) Kutta 3/8 (or ``method``), stage-ordered aux
    y = decoder(latent)                  -> (B, S, T, R)

:meth:`UDEForecaster.forward` is the plain twin of the whole serving path
that ``fiude_tpu_torch.ops.fused_ude.FusedForecaster`` runs through the two
CUDA kernels.  With ``fused_train`` the same forward is the training path:
the encoder runs through K3/K4 (``ops.fused_gru_train``) and, when the model
takes one Kutta 3/8 step an interval (``method="rk4"``, ``substeps=1``), the
trajectory through K5/K6 (``ops.fused_train``), which stream every
evaluation's rates and Fa as the aux or, with ``fused_stats`` (which
``train.experiment.build_trainer`` sets with ``fused_train``, as the
production sweeps do), reduce the loss's aux to five masked sums on the card.
Any other fixed method or sub-stepping integrates on the plain
``odeint_grid``, as the JAX package does (``fiude_tpu/models/vae.py:292-293,
364-369``), with the full stage aux.

The Bayes families (CONNb, SONNb, UONNb; ``models.bayes``) draw fresh weight
noise on every RHS evaluation from ``(noise_seed, e)``; their serving twin is
``ops.fused_bayes.FusedBayesForecaster`` (K7) and with ``fused_train`` their
trajectory runs through K8/K9 (``ops.fused_bayes_train``).

Entry points run on the card: :meth:`UDEForecaster.build` puts the model on
the CUDA device unless the caller passes ``device="cpu"``
(:func:`resolve_device`).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from fiude_tpu_torch.models.bayes import BayesNeuralAug, BayesSIRRates, BayesUDE
from fiude_tpu_torch.models.decoder import LinearDecoder
from fiude_tpu_torch.models.encoders import BackGRUEncoder
from fiude_tpu_torch.models.rhs import UDE, NeuralAug, SIRRates
from fiude_tpu_torch.ops.integrate import odeint_grid

_RHS = {"Fp": SIRRates, "CONN": SIRRates,
        "Fa": NeuralAug, "SONN": NeuralAug,
        "FaFp": UDE, "UONN": UDE,
        "Bayes_Fp": BayesSIRRates, "CONNb": BayesSIRRates,
        "Bayes_Fa": BayesNeuralAug, "SONNb": BayesNeuralAug,
        "Bayes_FaFp": BayesUDE, "UONNb": BayesUDE}
# the reference's RHS constructors take **kwargs and ignore extras
# (lib/models.py:110,159,200): the sizes each family reads
_RHS_KWARGS = {SIRRates: ("net_sizes",), NeuralAug: ("aug_net_sizes",),
               UDE: ("net_sizes", "aug_net_sizes"),
               BayesSIRRates: ("net_sizes", "prior_std"),
               BayesNeuralAug: ("aug_net_sizes", "prior_std"),
               BayesUDE: ("net_sizes", "aug_net_sizes", "prior_std")}


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: the current CUDA device unless
    the caller names one.  The CPU is taken only when asked for
    (``device="cpu"``), since a CPU model runs the kernels' plain twins; with
    no ``device`` and no card this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: fiude_tpu_torch runs on the card by default; pass "
            "device=\"cpu\" to build on the CPU (the kernels' plain twins)")
    return torch.device("cuda", torch.cuda.current_device())


def grid_steps(t, device, dtype) -> torch.Tensor:
    """The steps of the grid ``t``, taken in float64 on the host and cast to
    ``dtype`` on ``device``: the ``dts`` of the fused training trajectory.  A
    caller that runs many forwards on one grid makes them once and passes them
    as ``forward(dts=)`` (the trainer does, once a call)."""
    grid = torch.as_tensor(t).detach().to("cpu", torch.float64)
    return (grid[1:] - grid[:-1]).to(device, dtype)


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
    ``z_prior``: the S and I stds, a pair or a tensor on ``mean``'s device
    (then no copy from the host).  Returns ``(prior_mean, prior_std)`` shaped
    like ``mean``."""
    prior_mean = torch.cat([mean[..., :2], torch.zeros_like(mean[..., 2:])], dim=-1)
    std = torch.cat([torch.as_tensor(z_prior, dtype=mean.dtype, device=mean.device),
                     torch.ones(latent_dim - len(z_prior) - 1, dtype=mean.dtype,
                                device=mean.device)])
    return prior_mean, torch.abs(std).expand(prior_mean.shape)


class ForwardExtras(NamedTuple):
    mean: torch.Tensor
    std: Optional[torch.Tensor]
    latent: torch.Tensor
    aux: Any = None
    """the stage-ordered RHS aux {"rates", "fa"} (T-1, stages, B, R, k), with
    sub-steps (T-1, substeps, stages, B, R, k), or from K5/K6 (K8/K9) with
    ``fused_stats`` {"rate_stats": (r1, r2, count), "fa_sq": f2}"""


class UDEForecaster(nn.Module):
    """Encoder / ODE / decoder stack."""

    def __init__(self, encoder: BackGRUEncoder, ode: nn.Module,
                 decoder: LinearDecoder, *, latent_dim: int = 8,
                 n_regions: int = 1, uncertainty: bool = True,
                 method: str = "rk4", substeps: int = 1, ic_jitter: float = 1e-5,
                 fused_train: bool = False, fused_stats: bool = False):
        super().__init__()
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
              device=None, **kwargs) -> "UDEForecaster":
        """Mirror of ``fiude_tpu``'s ``UDEForecaster.build`` (reference
        ``lib/VAE.py:36-89``) with one config dict per submodule.

        Weights are drawn on the CPU from ``generator`` (seed 0 when None),
        in the order encoder, ODE, decoder, then moved to ``device``: one
        seed gives the same model on every device.  ``device=None`` is the
        CUDA device (:func:`resolve_device`); tests pass ``device="cpu"``.
        """
        device = resolve_device(device)
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
        ode_kw = {k: (v if k == "prior_std" else tuple(v))
                  for k, v in (ode_params or {}).items() if k in _RHS_KWARGS[rhs_cls]}

        encoder = BackGRUEncoder(n_regions, n_qs=n_qs, latent_dim=latent_dim - 1,
                                 uncertainty=uncertainty, generator=generator,
                                 dtype=dtype, **enc_params)
        ode = rhs_cls(n_regions, latent_dim, generator=generator, dtype=dtype,
                      **ode_kw)
        decoder = LinearDecoder(n_regions, generator=generator, dtype=dtype,
                                **(dec_params or {}))
        model = cls(encoder, ode, decoder, latent_dim=latent_dim,
                    n_regions=n_regions, uncertainty=uncertainty, **kwargs)
        return model.to(device)

    def sample_eps(self, batch_size: int, n_samples: int, *,
                   generator: torch.Generator,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(S, B, R, Le) standard-normal draws on ``generator``'s device."""
        return torch.randn(n_samples, batch_size, self.n_regions,
                           self.encoder.latent_dim, generator=generator,
                           dtype=dtype, device=generator.device)

    @property
    def is_bayes(self) -> bool:
        return getattr(self.ode, "uncertainty", "none") == "bayes"

    @property
    def fused_trajectory(self) -> bool:
        """Whether the trajectory runs through K5/K6 (K8/K9): exactly when the
        JAX package takes its fused kernel, ``fused_train`` with one Kutta 3/8
        step an interval.  ``rk4_38`` is the same rule but, as there, takes
        the plain path."""
        return self.fused_train and self.method == "rk4" and self.substeps == 1

    def rhs_fn(self, fa_w: float = 1.0):
        """Bind ``fa_w`` (read by the UDE families only) into ``(t, y) ->
        (dy, aux)``; a Bayes RHS also takes ``seed=`` and ``e=``, which
        ``odeint_grid(..., noise_seed=)`` passes on every evaluation."""
        if isinstance(self.ode, UDE):
            return lambda t, y: self.ode(t, y, fa_w=fa_w)
        if isinstance(self.ode, BayesUDE):
            return lambda t, y, **noise: self.ode(t, y, fa_w=fa_w, **noise)
        return self.ode

    def _encode(self, x: torch.Tensor):
        """Encoder forward ``x -> (mean, std)``; with ``fused_train`` a
        Back-GRU encoder runs through K3/K4 on the card (no VMEM guard: on a
        CUDA tensor the kernels run or raise)."""
        if self.fused_train and isinstance(self.encoder, BackGRUEncoder):
            from fiude_tpu_torch.ops.fused_gru_train import encode_train  # ops import models
            return encode_train(x, self.encoder)
        return self.encoder(x)

    def _fused_trajectory(self, z: torch.Tensor, t, fa_w, time_mask, noise_seed, dts=None):
        """K5/K6, K8/K9 for a Bayes family: the latent trajectory and the aux,
        streamed in the ``odeint_grid`` layout or, with ``fused_stats``, as the
        masked statistics (``fiude_tpu/models/vae.py:292-360``).  ``dts``:
        the grid's steps on ``z``'s device, made from ``t`` when None."""
        from fiude_tpu_torch.ops.fused_bayes import pack_bayes_field
        from fiude_tpu_torch.ops.fused_bayes_train import bayes_train_trajectory
        from fiude_tpu_torch.ops.fused_train import (
            aux_to_model_layout, train_trajectory, traj_to_model_layout,
        )
        from fiude_tpu_torch.ops.fused_ude import pack_field
        batch, n_regions, latent_dim = z.shape
        if dts is None:
            dts = grid_steps(t, z.device, z.dtype)
        if time_mask is None:
            tmask = torch.ones_like(dts)
        else:
            tmask = torch.as_tensor(time_mask).to(z.device, z.dtype)
        tail = z[..., 3:].reshape(batch, -1)
        head = z[..., :3].reshape(batch, -1)
        kw = dict(fa_w=fa_w, dts=dts, tmask=tmask, stats_mode=self.fused_stats)
        if self.is_bayes:
            bw = pack_bayes_field(self.ode, detach=False)
            w = bw.mean
            traj, *rest = bayes_train_trajectory(head, tail, bw, seed=noise_seed, **kw)
        else:
            w = pack_field(self.ode, detach=False)
            traj, *rest = train_trajectory(head, tail, w, **kw)
        latent = traj_to_model_layout(traj, tail, n_regions, latent_dim)
        if not self.fused_stats:     # the mask is then the loss's
            return latent, aux_to_model_layout(*rest, dts.shape[0] + 1, n_regions)
        r1, r2, f2 = rest
        aux = {}
        if w.n0_fp:
            aux["rate_stats"] = (r1, r2, 4.0 * batch * n_regions * tmask.sum())
        if w.aug:
            aux["fa_sq"] = f2
        return latent, aux

    def forward(self, x: torch.Tensor, t, eps: torch.Tensor, *,
                fa_w: float = 1.0, time_mask=None, noise_seed: Optional[int] = None,
                dts: Optional[torch.Tensor] = None):
        """x: (B, T_in, F) window; t: (T,) grid; eps: (S, B, R, Le);
        ``time_mask``: optional (T-1,) per-interval loss weights of the padded
        curriculum, read only by K5/K6 (K8/K9) in stats mode (every other
        path applies it in the loss).  ``noise_seed``: the weight-noise seed of a
        Bayes family (0 when None, as the JAX package defaults its key);
        evaluation ``e`` draws from ``(noise_seed, e)``, ``e = 4*i + stage``
        for one Kutta 3/8 step an interval (``ops.integrate`` for the others).
        ``dts``: the steps of ``t`` on the model's device (:func:`grid_steps`),
        read by K5/K6 (K8/K9) only, which otherwise make them from ``t``
        every call; the plain integrator steps from ``t`` on the host.

        Returns ``(y_pred (B, S, T, R), ForwardExtras)``.
        """
        n_samples, batch = eps.shape[0], eps.shape[1]
        mean, std = self._encode(x)
        if not self.uncertainty:
            n_samples, eps = 1, eps[:1]
        z = reparam(eps, std, mean, uncertainty=self.uncertainty)
        z = z + self.ic_jitter
        if self.is_bayes and noise_seed is None:
            noise_seed = 0
        if self.fused_trajectory:
            latent, aux = self._fused_trajectory(z, t, fa_w, time_mask, noise_seed, dts)
        else:
            latent, aux = odeint_grid(self.rhs_fn(fa_w), z, t, method=self.method,
                                      substeps=self.substeps,
                                      noise_seed=noise_seed if self.is_bayes else None)
        y = self.decoder(latent)                               # (T, S*B, R)
        y = y.reshape(y.shape[0], n_samples, batch, self.n_regions)
        return y.permute(2, 1, 0, 3), ForwardExtras(mean, std, latent, aux)
