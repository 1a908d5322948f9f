"""Philox4x32-10 and the Box-Muller normal of the Bayes weight noise, frozen.

A copy of ``fiude_tpu_torch/ops/philox.py`` as it stood when the benchmark
was defined (commit 4e0a429), kept here so that the reference's draw cannot
move with the program.  A draw is a pure function of

    (seed, evaluation e, weight array k, element i)

with counter ``(i, k, e, 0)`` and key ``(seed & 0xffffffff, seed >> 32)``.
The top 23 bits of a word make a float32 in [1, 2); ``u1 = 2 - m1`` lies in
(0, 1], ``u2 = m2 - 1`` in [0, 1), and ``z = sqrt(-2 log u1) cos(2 pi u2)``
from words 0 and 1, in float32.  The 32 x 32 -> 64 bit products are formed in
int64 from 16-bit limbs.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57     # the round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85     # the key schedule's Weyl increments
_MASK = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def _mulhilo(m: int, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    upper = m * (a >> 16)
    lower = m * (a & 0xFFFF)
    hi = (upper + (lower >> 16)) >> 16
    lo = (((upper & 0xFFFF) << 16) + lower) & _MASK
    return hi, lo


def philox4x32(counter: Sequence[torch.Tensor], key: Tuple[int, int], rounds: int = 10):
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
    return (word >> 9).to(torch.float32) * (2.0 ** -23) + 1.0


def normal_at(seed: int, e: torch.Tensor, k: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """float32 standard normals at evaluations ``e``, arrays ``k``, elements
    ``i`` (int64 tensors that broadcast together)."""
    i, k, e = torch.broadcast_tensors(i, k, e)
    w0, w1, _, _ = philox4x32((i, k, e, torch.zeros_like(i)),
                              (int(seed) & _MASK, (int(seed) >> 32) & _MASK))
    u1 = 2.0 - _unit_float(w0)
    u2 = _unit_float(w1) - 1.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def array_normals(seed: int, evals: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(len(evals), n) float32: elements 0..n-1 of weight array ``k`` at each
    evaluation in ``evals`` (an int64 vector)."""
    i = torch.arange(n, dtype=torch.int64, device=evals.device)
    kk = torch.full((1, 1), int(k), dtype=torch.int64, device=evals.device)
    return normal_at(seed, evals.reshape(-1, 1), kk, i.reshape(1, -1))
