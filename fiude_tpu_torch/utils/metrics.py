"""Evaluation metrics (parity with reference ``lib/Metrics.py``).

Counterpart of ``fiude_tpu/utils/metrics.py:34-100`` with numpy, scipy and
torch (no pandas).  The host forms run on forecast arrays pulled back from
the device for the results table:

* :func:`nll`: mean negative Gaussian log-density (``lib/Metrics.py:5-13``).
* :func:`mae`: mean absolute error (``:15-23``).
* :func:`mb_log`: CDC-style multi-bin log score
  ``log(cdf(true+0.6) - cdf(true-0.5))`` with zero probability floored at
  4.5399929762484854e-05 (``:25-60``); ``bins=True`` scores a CDC binned
  probability table instead (``:26-41``).
* :func:`skill`: ``exp(mean(mb_log))`` (``:62-75``).

Each also takes, in place of the arrays, a table with ``True`` / ``Pred`` /
``Std`` columns (``lib/Metrics.py:6-9``): a
:class:`~fiude_tpu_torch.data.tables.Frame` or any mapping from those names
to arrays.  The table form of :func:`mae` skips missing values, as the JAX
package's DataFrame form does (pandas' mean fills them with 0 and divides by
the count).  A binned table (:func:`mb_log` / :func:`skill` with
``bins=True``) is a table whose columns are bin left edges plus ``True``,
e.g. ``tables.read_frame(path, parse_dates=False)`` of a CDC CSV.

:func:`nll_torch`, :func:`mb_log_torch` and :func:`skill_torch` compute on
the tensor's own device (the JAX package's ``*_jnp`` forms, ``:87-100``),
the normal CDF formed as JAX forms it (:func:`_ndtr`).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from scipy.stats import norm

from fiude_tpu_torch.data.tables import Frame
from fiude_tpu_torch.ops.stats import normal_logpdf

_MBL_FLOOR = 4.5399929762484854e-05
_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def _is_table(x) -> bool:
    return isinstance(x, (Frame, Mapping))


def _columns(table):
    """``(names, columns)`` of a Frame or a mapping of names to arrays."""
    if isinstance(table, Frame):
        return list(table.columns), [table.values[:, j] for j in range(len(table.columns))]
    return list(table), [np.asarray(table[k], dtype=float) for k in table]


def _from_table(true, mean, std):
    """Unpack a ``True`` / ``Pred`` / ``Std`` table (lib/Metrics.py:6-9)."""
    if not _is_table(true):
        return true, mean, std
    cols = dict(zip(*_columns(true)))
    return cols["True"], cols["Pred"], cols["Std"]


def nll(true, mean=None, std=None, bins=False):
    true, mean, std = _from_table(true, mean, std)
    return -np.mean(norm.logpdf(true, loc=mean, scale=std))


def mae(true, mean=None, std=None, bins=False):
    if _is_table(true):
        t, m, _ = _from_table(true, mean, std)
        return np.nanmean(np.abs(np.asarray(t, float) - np.asarray(m, float)))
    return np.mean(np.abs(true - mean))


def _mb_log_binned(table):
    """CDC binned-table log score (lib/Metrics.py:26-41).

    Per row, ``log`` of the total probability mass in the bins within +-0.5
    of the observation's own bin (``floor(true*10)/10``): an 11-bin window at
    CDC's 0.1-percentage-point resolution, every boundary rounded to one
    decimal.  The mass is summed over a row-major array, as numpy sums the
    JAX package's product.
    """
    names, columns = _columns(table)
    edges = np.round(np.asarray([float(n) for n in names if n != "True"]), 1)
    probs = np.stack([c for n, c in zip(names, columns) if n != "True"], axis=1)
    correct = np.round(np.floor(np.asarray(columns[names.index("True")], float) * 10) / 10, 1)
    lower = np.round(correct - 0.5, 1)[:, None]
    upper = np.round(correct + 0.5, 1)[:, None]
    in_window = (edges[None, :] >= lower) & (edges[None, :] <= upper)
    mass = np.sum(np.ascontiguousarray(probs, dtype=float) * in_window, axis=1)
    return np.log(mass)


def mb_log(true, mean=None, std=None, bins=False):
    if bins:
        return _mb_log_binned(true)
    true, mean, std = _from_table(true, mean, std)
    dist = norm(loc=mean, scale=std)
    cdf = dist.cdf(true + 0.6) - dist.cdf(true - 0.5)
    cdf = np.where(cdf == 0, _MBL_FLOOR, cdf)
    return np.log(cdf)


def skill(true, mean=None, std=None, bins=False):
    return np.exp(mb_log(true, mean, std, bins).mean())


# -- device-side variants ----------------------------------------------------

def nll_torch(true: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return -torch.mean(normal_logpdf(true, mean, std))


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """The normal CDF as ``jax.scipy.special.ndtr`` forms it: ``1 + erf`` near
    0, ``erfc`` in the lower tail, ``2 - erfc`` in the upper.
    ``torch.special.ndtr`` rounds the lower tail away (0 at x = -8.66, where
    the value is 2.4e-18), which moves the floored log score by up to 30."""
    w = x * _HALF_SQRT_2
    z = w.abs()
    y = torch.where(z < _HALF_SQRT_2, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def mb_log_torch(true: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    cdf = _ndtr((true + 0.6 - mean) / std) - _ndtr((true - 0.5 - mean) / std)
    cdf = torch.where(cdf == 0, torch.full_like(cdf, _MBL_FLOOR), cdf)
    return torch.log(cdf)


def skill_torch(true: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.mean(mb_log_torch(true, mean, std)))
