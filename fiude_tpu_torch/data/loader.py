"""Host-side batching (replaces ``torch.utils.data.DataLoader`` usage,
reference ``lib/regional_data_builder.py:276-284``).

Counterpart of ``fiude_tpu/data/loader.py:16-72`` (``ArrayLoader``,
``return_folds``, ``convert_to_arrays``), copied rather than imported:
``fiude_tpu/data/__init__.py`` pulls in pandas.
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


def return_folds(n: int, n_folds: int = 5, seed: int = 0):
    """K-fold index splits (reference lib/Old/Data_Constructor.py:14-23): a
    list of ``(train_idx, val_idx)`` pairs over a seeded permutation."""
    rng = np.random.default_rng(seed)
    folds = np.array_split(rng.permutation(n), n_folds)
    return [(np.concatenate([folds[j] for j in range(n_folds) if j != k]), folds[k])
            for k in range(n_folds)]


def convert_to_arrays(x_train, y_train, x_test, y_test, batch_size: int = 32,
                      shuffle: bool = True, seed: int = 0, dtype=np.float32):
    """Counterpart of the reference's ``convert_to_torch``
    (lib/regional_data_builder.py:276-284): ``(loader, x_test, y_test)``."""
    loader = ArrayLoader(np.asarray(x_train, dtype), np.asarray(y_train, dtype),
                         batch_size=batch_size, shuffle=shuffle, seed=seed)
    return loader, np.asarray(x_test, dtype), np.asarray(y_test, dtype)
