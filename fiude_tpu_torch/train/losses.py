"""The gated multi-term VAE loss stack (reference ``lib/VAE.py:142-198``).

Counterpart of ``fiude_tpu/train/losses.py:36-187,190-208,417-497``.  Every
term is a function of the forward outputs; :class:`LossConfig` gates them
as the reference's ``training_info`` dicts do (``run_ode.py:71-78``):

* **nll**: Gaussian NLL of the MC ensemble; the std over the sample axis is
  unbiased, and entries where ``y == -1`` are zeroed but stay in the mean's
  denominator (reference ``lib/train_functions.py:81-90``);
* **mse**: against every ensemble member;
* **kl_z**: ``kl_w * KL(prior(mean) || N(mean, std)).sum(-1).mean() / len_tr``;
* **kl_p**: KL of the rate prior against the empirical (beta, gamma)
  posterior, from the stacked rates or from the fused kernel's sufficient
  statistics (``kl_params_from_stats``);
* **fa_norm**: Frobenius norm of every Fa evaluation;
* **reg_loss**: ``0.1 * sum`` of out-of-[0, 1] penalties on the S, I, R
  trajectory;
* the cyclical KL-annealing weight (reference ``lib/train_functions.py:17-44``).

The constant vectors (the rate prior's means and stds, KL_z's prior stds)
reach the terms as tensors of :class:`LossConstants`: made
from the host by :func:`loss_constants`, which the trainer calls once a
training call, so that a step copies nothing from the host to the card.

``compute_loss_sharded`` waits for the multi-device slice (``ROADMAP.md``,
queue A, "Multi-device").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from fiude_tpu_torch.models.rhs import empirical_rate_posterior
from fiude_tpu_torch.models.vae import make_prior
from fiude_tpu_torch.ops.fused_train import RATE_SHIFT
from fiude_tpu_torch.ops.stats import kl_normal, masked_mean_std, normal_logpdf


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss gating, mirroring the reference's per-model ``training_info``."""
    nll: bool = True
    mse: bool = False
    kl_z: bool = True
    kl_p: bool = True
    fa_norm: float = 0.0       # weight; 0 disables (the reference uses 1e-1)
    reg_loss: bool = True
    anneal: bool = True
    ode_kl_w: float = 1.0      # weight of the variational-layer KL (Bayes RHS)


#: Reference model-family presets (run_ode.py:71-78).
TRAINING_INFO = {
    "UONN": LossConfig(nll=True, mse=False, kl_z=True, kl_p=True,
                       fa_norm=1e-1, reg_loss=True, anneal=True),
    "CONN": LossConfig(nll=True, mse=False, kl_z=True, kl_p=True,
                       fa_norm=0.0, reg_loss=True, anneal=True),
    "SONN": LossConfig(nll=True, mse=False, kl_z=True, kl_p=False,
                       fa_norm=0.0, reg_loss=False, anneal=True),
    "UONNb": LossConfig(nll=True, mse=False, kl_z=True, kl_p=True,
                        fa_norm=1e-1, reg_loss=True, anneal=True),
    "CONNb": LossConfig(nll=True, mse=False, kl_z=True, kl_p=True,
                        fa_norm=0.0, reg_loss=True, anneal=True),
    "SONNb": LossConfig(nll=True, mse=False, kl_z=True, kl_p=False,
                        fa_norm=0.0, reg_loss=False, anneal=True),
}


#: KL_z's prior stds of the S and I dimensions (reference lib/models.py:9-14).
Z_PRIOR = (0.1, 0.01)


class LossConstants(NamedTuple):
    """The loss's constant vectors as tensors on the loss's device."""
    prior_means: torch.Tensor
    prior_stds: torch.Tensor
    z_prior: torch.Tensor


def loss_constants(prior_params: Optional[Dict[str, Any]] = None,
                   dtype: torch.dtype = torch.float32, device=None) -> LossConstants:
    """:class:`LossConstants` for the rate prior ``prior_params`` ({"means",
    "stds"}; the reference's when None), in ``dtype`` on ``device``."""
    prior_params = prior_params or {"means": [0.8, 0.55], "stds": [0.2, 0.2]}

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return LossConstants(vec(prior_params["means"]), vec(prior_params["stds"]), vec(Z_PRIOR))


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    """Cyclical KL-annealing schedule (reference lib/VAE.py:91-97 defaults)."""
    anneal: bool = True
    reset_pos: int = 10000
    split: float = 0.5
    lower: float = 0.0
    upper: float = 1.0
    kind: str = "cosine"


def kl_annealing(step, cfg: AnnealConfig) -> torch.Tensor:
    """Annealed KL weight at (1-indexed) train ``step``, a float32 scalar
    computed in float32 as ``fiude_tpu`` computes it.

    The step wraps into (0, reset_pos] (the reference's ``while step >
    reset_pos: step -= reset_pos``).  The cosine ramp is written
    ``sin^2(pi f / 2)``: equal to ``0.5 * (1 - cos(pi f))`` but free of that
    form's float32 cancellation at small steps.
    """
    if not cfg.anneal:
        return torch.tensor(1.0, dtype=torch.float32)
    step = torch.as_tensor(step, dtype=torch.float32)
    s = torch.remainder(step - 1.0, float(cfg.reset_pos)) + 1.0
    half = float(int(cfg.reset_pos * cfg.split))
    frac = s / half
    if cfg.kind == "linear":
        ramp = frac * (cfg.upper - cfg.lower) + cfg.lower
    elif cfg.kind == "sigmoid":
        ramp = cfg.lower + (cfg.upper - cfg.lower) / (1.0 + torch.exp(-10.0 * (frac - 0.5)))
    elif cfg.kind == "cosine":
        ramp = cfg.lower + torch.square(torch.sin(math.pi / 2 * frac)) * (cfg.upper - cfg.lower)
    else:
        raise ValueError(f"unknown anneal kind {cfg.kind!r}")
    return torch.where(s >= half, torch.tensor(cfg.upper, dtype=torch.float32), ramp)


def _masked_denominator(eval_mask, dtype, *dims) -> torch.Tensor:
    return math.prod(dims) * torch.sum(eval_mask.to(dtype))


def nll_loss(y_pred, y, mean: bool = True, eval_mask=None):
    """MC-ensemble Gaussian NLL with -1 masking; y_pred (B, S, T, R), y (B, T, R).

    ``eval_mask`` (T,) 0/1 drops padded-curriculum columns from the numerator
    AND the denominator, reproducing the exact mode's mean over
    ``y[:, eval_pts]``.
    """
    y_std = torch.std(y_pred, dim=1, correction=1)
    y_mean = torch.mean(y_pred, dim=1)
    nll = -normal_logpdf(y, y_mean, y_std) * (y != -1.0).to(y_pred.dtype)
    if not mean:
        return nll
    if eval_mask is None:
        return torch.mean(nll)
    w = eval_mask.to(nll.dtype).reshape(1, -1, 1)
    return torch.sum(nll * w) / _masked_denominator(eval_mask, nll.dtype,
                                                    y.shape[0], y.shape[2])


def mse_loss(y_pred, y, eval_mask=None):
    """Mean squared error against every ensemble member (lib/VAE.py:155)."""
    se = torch.square(y_pred - y[:, None])
    if eval_mask is None:
        return torch.mean(se)
    w = eval_mask.to(se.dtype).reshape(1, 1, -1, 1)
    return torch.sum(se * w) / _masked_denominator(eval_mask, se.dtype, se.shape[0],
                                                   se.shape[1], se.shape[3])


def kl_z_loss(mean, std, *, latent_dim: int, len_tr: int, z_prior=Z_PRIOR):
    """KL(IC prior || encoder posterior) (reference lib/VAE.py:167)."""
    pm, ps = make_prior(mean, latent_dim=latent_dim, z_prior=z_prior)
    return torch.mean(torch.sum(kl_normal(pm, ps, mean, std), dim=-1)) / len_tr


def _broadcast_mask(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim)).expand(like.shape)


def kl_params_loss(rates_aux, *, prior_means=(0.8, 0.55), prior_stds=(0.2, 0.2),
                   mask=None):
    """KL(rate prior || empirical (beta, gamma) posterior) from the stacked
    rates (any leading dims, then (R, 2)); ``mask`` weights the leading
    steps (the padded curriculum)."""
    if mask is None:
        post_mean, post_std = empirical_rate_posterior(rates_aux)
    else:
        m = _broadcast_mask(mask.to(rates_aux.dtype), rates_aux).reshape(-1, 2)
        post_mean, post_std = masked_mean_std(rates_aux.reshape(-1, 2), m, axis=0)
    pm = torch.as_tensor(prior_means, dtype=rates_aux.dtype, device=rates_aux.device)
    ps = torch.as_tensor(prior_stds, dtype=rates_aux.dtype, device=rates_aux.device)
    return torch.mean(kl_normal(pm, ps, post_mean, post_std))


def kl_params_from_stats(r1, r2, count, *, prior_means=(0.8, 0.55),
                         prior_stds=(0.2, 0.2)):
    """:func:`kl_params_loss` from the fused kernel's statistics: ``r1``,
    ``r2`` the masked sums and sums of squares of the ``RATE_SHIFT``-shifted
    (beta, gamma) evaluations, ``count`` the masked count per column.  The
    variance of shifted moments does not depend on the shift, so this is
    :func:`masked_mean_std` (ddof 1) computed another way."""
    count = torch.as_tensor(count, dtype=r1.dtype, device=r1.device)
    cnt = torch.clamp(count, min=1.0)
    mean = r1 / cnt
    post_mean = torch.stack([s + mean[..., k] for k, s in enumerate(RATE_SHIFT)], dim=-1)
    sq = r2 - torch.square(r1) / cnt
    post_std = torch.sqrt(torch.clamp(sq, min=0.0) / torch.clamp(count - 1.0, min=1.0))
    pm = torch.as_tensor(prior_means, dtype=r1.dtype, device=r1.device)
    ps = torch.as_tensor(prior_stds, dtype=r1.dtype, device=r1.device)
    return torch.mean(kl_normal(pm, ps, post_mean, post_std))


def fa_norm_loss(fa_aux, mask=None):
    """Frobenius norm of every Fa evaluation (lib/VAE.py:180)."""
    sq = torch.square(fa_aux)
    if mask is not None:
        sq = sq * _broadcast_mask(mask.to(fa_aux.dtype), fa_aux)
    return torch.sqrt(torch.sum(sq))


def latent_init_loss(x, mask=None):
    """Sum of |x| where x < 0 plus |1 - x| where x > 1 (train_functions.py:116-126)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    penalty = (torch.where(x < 0, torch.abs(x), zero)
               + torch.where(x > 1, torch.abs(1.0 - x), zero))
    if mask is not None:
        penalty = penalty * _broadcast_mask(mask.to(x.dtype), penalty)
    return torch.sum(penalty)


def compute_loss(loss_cfg: LossConfig, y_pred, y_true, extras, *, kl_w,
                 latent_dim: int, len_tr: int,
                 prior_params: Optional[Dict[str, Any]] = None,
                 time_mask=None, eval_mask=None, ode_kl=None,
                 consts: Optional[LossConstants] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The gated loss: ``(scalar loss, metrics)``.

    ``time_mask`` (T-1,) masks the solver aux (kl_p, fa_norm) and the latent
    trajectory (reg_loss) beyond the active horizon of the padded
    curriculum; ``eval_mask`` (T,) masks the nll/mse columns.  Both None
    reproduce the reference's exact-horizon loss.  With the fused stats
    path, ``extras.aux`` holds ``rate_stats`` / ``fa_sq`` already masked.
    ``ode_kl``: the variational layers' KL of a Bayes RHS
    (``models.bayes.variational_kl``), weighted by ``loss_cfg.ode_kl_w``.
    ``consts``: the constants on ``y_pred``'s device (:func:`loss_constants`
    of ``prior_params``), made here when None.
    """
    if consts is None:
        consts = loss_constants(prior_params, y_pred.dtype, y_pred.device)
    loss = torch.zeros((), dtype=y_pred.dtype, device=y_pred.device)
    metrics: Dict[str, torch.Tensor] = {}
    aux = extras.aux if isinstance(extras.aux, dict) else {}
    latent_mask = None
    if time_mask is not None:
        latent_mask = torch.cat([torch.ones_like(time_mask[:1]), time_mask])

    if loss_cfg.mse:
        metrics["mse"] = mse_loss(y_pred, y_true, eval_mask=eval_mask)
        loss = loss + metrics["mse"]
    if loss_cfg.nll:
        metrics["nll"] = nll_loss(y_pred, y_true, eval_mask=eval_mask)
        loss = loss + metrics["nll"]
    if loss_cfg.kl_z:
        metrics["kl_latent"] = kl_w * kl_z_loss(extras.mean, extras.std, latent_dim=latent_dim,
                                                len_tr=len_tr, z_prior=consts.z_prior)
        loss = loss + metrics["kl_latent"]
    if loss_cfg.kl_p:
        if "rate_stats" in aux:
            klp = kl_params_from_stats(*aux["rate_stats"], prior_means=consts.prior_means,
                                       prior_stds=consts.prior_stds)
        else:
            klp = kl_params_loss(aux["rates"], prior_means=consts.prior_means,
                                 prior_stds=consts.prior_stds, mask=time_mask)
        metrics["kl_params"] = klp
        loss = loss + klp
    if loss_cfg.fa_norm and loss_cfg.fa_norm > 0:
        if "fa_sq" in aux:
            norm = torch.sqrt(aux["fa_sq"])
        else:
            norm = fa_norm_loss(aux["fa"], mask=time_mask)
        metrics["Fa_norm"] = norm
        loss = loss + loss_cfg.fa_norm * norm
    if loss_cfg.reg_loss:
        metrics["reg_loss"] = 0.1 * latent_init_loss(extras.latent[..., :3],
                                                     mask=latent_mask)
        loss = loss + metrics["reg_loss"]
    if ode_kl is not None:
        metrics["ode_kl"] = loss_cfg.ode_kl_w * ode_kl
        loss = loss + metrics["ode_kl"]

    metrics["loss"] = loss
    metrics["kl_w"] = torch.as_tensor(kl_w, dtype=y_pred.dtype).to(y_pred.device)
    return loss, metrics
