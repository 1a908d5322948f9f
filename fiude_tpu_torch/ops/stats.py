"""Diagonal-Gaussian math of the loss stack, with torch's conventions.

Counterpart of ``fiude_tpu/ops/stats.py:25-67``:

* :func:`normal_logpdf` is ``torch.distributions.Normal(mean, std).log_prob``
  (reference ``lib/train_functions.py:84``);
* :func:`kl_normal` is ``kl_divergence(Normal(p), Normal(q))`` (reference
  ``lib/train_functions.py:79,167``);
* :func:`std` is unbiased by default (``torch.std``), which the MC-ensemble
  NLL and the empirical (beta, gamma) posterior depend on;
* :func:`masked_mean` / :func:`masked_mean_std` count only masked-in
  elements (the padded-curriculum loss path).
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def normal_logpdf(x, mean, std):
    """Elementwise Gaussian log-density."""
    return -torch.square(x - mean) / (2.0 * torch.square(std)) - torch.log(std) - _LOG_SQRT_2PI


def kl_normal(p_mean, p_std, q_mean, q_std):
    """Elementwise ``KL(N(p_mean, p_std) || N(q_mean, q_std))``."""
    var_ratio = torch.square(p_std / q_std)
    t1 = torch.square((p_mean - q_mean) / q_std)
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def std(x, axis=0, ddof: int = 1):
    """Standard deviation along ``axis``, unbiased by default."""
    return torch.std(x, dim=axis, correction=ddof)


def masked_mean(x, mask, axis=None, eps: float = 0.0):
    """Mean of ``x`` over the elements where ``mask`` is truthy."""
    mask = mask.to(x.dtype)
    if axis is None:
        total, count = torch.sum(x * mask), torch.sum(mask)
    else:
        total, count = torch.sum(x * mask, dim=axis), torch.sum(mask, dim=axis)
    return total / torch.clamp(count, min=1.0 + eps)


def masked_mean_std(x, mask, axis=0, ddof: int = 1):
    """Mean and (unbiased by default) std along ``axis`` over masked-in
    elements only."""
    mask = mask.to(x.dtype)
    count = torch.sum(mask, dim=axis)
    mean = torch.sum(x * mask, dim=axis) / torch.clamp(count, min=1.0)
    sq = torch.sum(torch.square(x - mean) * mask, dim=axis)
    return mean, torch.sqrt(sq / torch.clamp(count - ddof, min=1.0))
