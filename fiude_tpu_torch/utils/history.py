"""Batch/epoch metric accumulation (reference ``lib/train_functions.py:142-176``).

Counterpart of ``fiude_tpu/utils/history.py`` (numpy only).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


class History:
    """Accumulates per-batch metric dicts; averages them per epoch."""

    def __init__(self):
        self.batches: List[Dict[str, float]] = []
        self.batch_history: List[List[Dict[str, float]]] = []
        self.epoch_history: List[Dict[str, float]] = []

    def batch(self, metrics: Dict[str, float]):
        self.batches.append({k: float(v) for k, v in metrics.items()})

    def epoch(self) -> Dict[str, float]:
        if not self.batches:
            return {}
        keys = self.batches[0].keys()
        return {k: float(np.mean([b[k] for b in self.batches])) for k in keys}

    def reset(self):
        self.batch_history.append(self.batches)
        self.epoch_history.append(self.epoch())
        self.batches = []

    def save(self, path: str):
        """Write the epoch history as JSON."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.epoch_history, fh)

    @classmethod
    def load(cls, path: str) -> "History":
        h = cls()
        with open(path) as fh:
            h.epoch_history = json.load(fh)
        return h
