"""Philox4x32-10 and a Box-Muller normal as plain functions on tensors: the
plain version of the weight-noise draw inside the Bayes kernels.

No module of ``fiude_tpu`` corresponds: the JAX package seeds the TPU's own
generator, ``pltpu.prng_seed(seed, e)``, and maps its bits to normals in
``_kernel_normal`` (``fiude_tpu/ops/pallas_bayes.py:91-100``,
``pallas_bayes_train.py:95-102``).  The card has no such generator, so the
port's noise is a counter-based one (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", 2011), the same arithmetic here and in
``csrc/philox.cuh``: a draw is a pure function of

    (seed, evaluation e, weight array k, element i)

with counter ``(i, k, e, 0)`` and key ``(seed & 0xffffffff, seed >> 32)``.
So every block of a kernel draws the same weights for evaluation ``e``, the
backward re-derives the forward's noise in any order, and the plain model
path, the twins and the kernels see the same weights for the same seed.

The map from bits to a normal is the JAX package's: the top 23 bits of a
word make a float in [1, 2); ``u1 = 2 - m1`` lies in (0, 1] so the log's
argument is never 0, ``u2 = m2 - 1`` in [0, 1), and
``z = sqrt(-2 log u1) * cos(2 pi u2)``.  Words 0 and 1 of the Philox output
are used.  torch has no unsigned 64-bit multiply, so the 32 x 32 -> 64 bit
products are formed in int64 from 16-bit limbs.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57     # the round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85     # the key schedule's Weyl increments
_MASK = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def _mulhilo(m: int, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``m * a``, a in [0, 2^32) held in int64."""
    upper = m * (a >> 16)             # < 2^48
    lower = m * (a & 0xFFFF)          # < 2^48
    hi = (upper + (lower >> 16)) >> 16
    lo = (((upper & 0xFFFF) << 16) + lower) & _MASK
    return hi, lo


def philox4x32(counter: Sequence[torch.Tensor], key: Tuple[int, int], rounds: int = 10):
    """The Philox4x32 bijection: four int64 tensors of 32-bit words in, four
    out (Random123's ``philox4x32_R``)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit_float(word: torch.Tensor) -> torch.Tensor:
    """The float32 in [1, 2) whose mantissa is the word's top 23 bits."""
    return (word >> 9).to(torch.float32) * (2.0 ** -23) + 1.0


def normal_at(seed: int, e, k: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Standard normals (float32) for evaluation(s) ``e`` (an int or an int64
    tensor broadcasting against k and i), array indices ``k`` and element
    indices ``i`` (int64 tensors)."""
    if not isinstance(e, torch.Tensor):
        e = torch.full_like(i, int(e))
    i, k, e = torch.broadcast_tensors(i, k, e)
    w0, w1, _, _ = philox4x32((i, k, e, torch.zeros_like(i)),
                              (int(seed) & _MASK, (int(seed) >> 32) & _MASK))
    u1 = 2.0 - _unit_float(w0)
    u2 = _unit_float(w1) - 1.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def normal(seed: int, e: int, k: int, n: int, *, device=None) -> torch.Tensor:
    """``n`` standard normals (float32): elements 0..n-1 of weight array ``k``
    at evaluation ``e`` under ``seed``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return normal_at(seed, e, torch.full_like(i, int(k)), i)


@functools.lru_cache(maxsize=32)
def _packed_indices(sizes: Tuple[int, ...], device: str):
    k = torch.repeat_interleave(torch.arange(len(sizes), dtype=torch.int64),
                                torch.tensor(sizes, dtype=torch.int64))
    i = torch.cat([torch.arange(n, dtype=torch.int64) for n in sizes])
    return k.to(device), i.to(device)


def packed_normal(seed: int, e, sizes: Sequence[int], *, device=None) -> torch.Tensor:
    """The draw of one evaluation for arrays of ``sizes`` elements, laid end
    to end: (sum(sizes),) float32; with ``e`` an (E, 1) int64 tensor, every
    evaluation's draw at once, (E, sum(sizes))."""
    k, i = _packed_indices(tuple(int(n) for n in sizes), str(torch.device(device or "cpu")))
    return normal_at(seed, e, k, i)
