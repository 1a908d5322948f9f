"""Evaluation metrics (parity with reference ``lib/Metrics.py``).

Counterpart of ``fiude_tpu/utils/metrics.py:42-82`` in its array form (numpy
and scipy): these run on forecast arrays pulled back from the device for the
results table.

* :func:`nll`: mean negative Gaussian log-density (``lib/Metrics.py:5-13``).
* :func:`mae`: mean absolute error (``:15-23``).
* :func:`mb_log`: CDC-style multi-bin log score
  ``log(cdf(true+0.6) - cdf(true-0.5))`` with zero probability floored at
  4.5399929762484854e-05 (``:25-60``).
* :func:`skill`: ``exp(mean(mb_log))`` (``:62-75``).

The JAX package's functions also take a DataFrame with ``Pred``/``Std``/
``True`` columns, and ``mb_log`` a CDC binned table; both need pandas, which
the port does not use, and wait for ``ROADMAP.md``, queue A, "Host-side
data".
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm

_MBL_FLOOR = 4.5399929762484854e-05


def nll(true, mean, std):
    return -np.mean(norm.logpdf(true, loc=mean, scale=std))


def mae(true, mean, std=None):
    return np.mean(np.abs(true - mean))


def mb_log(true, mean, std):
    dist = norm(loc=mean, scale=std)
    cdf = dist.cdf(true + 0.6) - dist.cdf(true - 0.5)
    cdf = np.where(cdf == 0, _MBL_FLOOR, cdf)
    return np.log(cdf)


def skill(true, mean, std):
    return np.exp(mb_log(true, mean, std).mean())
