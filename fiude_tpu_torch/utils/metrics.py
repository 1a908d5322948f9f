"""Evaluation metrics (parity with reference ``lib/Metrics.py``).

Counterpart of ``nll`` in ``fiude_tpu/utils/metrics.py:42`` (numpy and
scipy, on arrays; the DataFrame input of the JAX package needs pandas, which
the port does not use).  The other metrics wait for ``ROADMAP.md``, queue A,
"Host-side data".
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm


def nll(true, mean, std):
    """Mean negative Gaussian log-density (``lib/Metrics.py:5-13``)."""
    return -np.mean(norm.logpdf(true, loc=mean, scale=std))
