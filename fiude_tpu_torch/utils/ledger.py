"""Crash-resumable sweep ledger (reference ``started.txt`` + FileLock).

Counterpart of ``fiude_tpu/utils/ledger.py:74-147``.  The reference
coordinates its worker processes through a file-locked text ledger: claim a
config by appending its key, mark it ``finished`` / ``failed`` afterwards
(``run_ode.py:106-119,167-170``, ``lib/utils.py:58-67``).  The same file
format, the same claim / mark / status / entries, and the same delimiter
match, so ``cfg1`` and ``cfg10`` are distinct keys.

Only the JAX package's python backend is ported: this module does not load
``native/ledger.cpp``.  It locks the same ``<path>.lock`` file with
``flock(2)`` (:func:`~fiude_tpu_torch.utils.results.file_lock`), which is
what the JAX package's ``filelock`` takes on POSIX and what
``native/ledger.cpp`` takes, so workers of both packages, of either JAX
backend, exclude each other on one ledger.
"""

from __future__ import annotations

import os
from typing import List, Optional

from fiude_tpu_torch.utils.results import file_lock


class Ledger:
    def __init__(self, path: str = "started.txt"):
        self.path = path
        self.lock_path = path + ".lock"

    def _read(self) -> List[str]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "r") as fh:
            return fh.read().splitlines()

    @staticmethod
    def _matches(line: str, key: str) -> bool:
        """A ledger line belongs to ``key`` iff it is the key itself or the
        key followed by status words (the reference's substring test,
        ``run_ode.py:109-119``, would take ``cfg1`` as claimed once ``cfg10``
        is)."""
        return line == key or line.startswith(key + " ")

    def claim(self, key: str) -> bool:
        """Atomically claim ``key``; False if already claimed."""
        with file_lock(self.lock_path):
            if any(self._matches(line, key) for line in self._read()):
                return False
            with open(self.path, "a") as fh:
                fh.write(key + "\n")
            return True

    def mark(self, key: str, status: str = "finished") -> None:
        """Append a status to the claimed line (lib/utils.py:58-67)."""
        with file_lock(self.lock_path):
            lines = self._read()
            with open(self.path, "w") as fh:
                for line in lines:
                    if self._matches(line, key):
                        line = line + " " + status
                    fh.write(line + "\n")

    def status(self, key: str) -> Optional[str]:
        for line in self._read():
            if self._matches(line, key):
                return line[len(key):].strip() or "claimed"
        return None

    def entries(self) -> List[str]:
        return self._read()
