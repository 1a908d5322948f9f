"""Host-side batching (replaces ``torch.utils.data.DataLoader`` usage,
reference ``lib/regional_data_builder.py:276-284``).

Counterpart of ``ArrayLoader`` in ``fiude_tpu/data/loader.py:16-49``, copied
rather than imported: ``fiude_tpu/data/__init__.py`` pulls in pandas.
Shuffled mini-batches from in-memory numpy arrays; the final partial batch
is kept (torch ``DataLoader`` default), and one seed gives the JAX loader's
batch order.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class ArrayLoader:
    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        if len(x) != len(y):
            raise ValueError(f"x and y differ in length: {len(x)} != {len(y)}")
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.x) // self.batch_size
        if not self.drop_last and len(self.x) % self.batch_size:
            n += 1
        return n

    def epoch_indices(self) -> np.ndarray:
        """One epoch's window order, consuming the shuffle RNG as ``__iter__``
        does."""
        idx = np.arange(len(self.x))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.drop_last:
            idx = idx[: len(idx) - len(idx) % self.batch_size]
        return idx

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self.epoch_indices()
        for start in range(0, len(idx), self.batch_size):
            sel = idx[start:start + self.batch_size]
            yield self.x[sel], self.y[sel]
