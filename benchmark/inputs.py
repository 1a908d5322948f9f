"""The benchmark's one generator of inputs: surveillance windows, Monte-Carlo
draws, weight-noise seeds and weights, all made from the run's seed.

A traffic mix (``traffic/<name>.json``) only sets the numbers: how many
windows, days of window, lag and horizon, samples, members and so on.  The
windows have the data tree's shapes and scaling (``data/builder.py``, the
port's ``DataConstructor``): a window is ``window + lag`` days of ``R * Q``
query columns (region-major blocks) and ``R`` ILI columns, the last ``lag``
days of ILI masked to -1; its target is ``window + horizon + 1`` days of ILI;
every series is scaled to [0, 1].  The series are made up: yearly epidemic
waves of random height, timing and width over a baseline, and queries that
follow their region's ILI a few days ahead, with noise.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.params import param_specs, unflatten

SEED_MOD = 2 ** 63


def torch_seed(*parts: int) -> int:
    """A torch generator seed from the run's seed and stream ids."""
    s = 0
    for p in parts:
        s = (s * 1_000_003 + int(p)) % SEED_MOD
    return s


def series(rng: np.random.Generator, days: int, R: int, Q: int) -> np.ndarray:
    """(days, R * Q + R) float32: query blocks region by region, then ILI."""
    t = np.arange(days, dtype=np.float64)[:, None]
    ili = rng.uniform(0.02, 0.08, size=(1, R)) + np.zeros((days, R))
    for start in range(-364, days + 364, 364):
        peak = start + rng.uniform(80.0, 140.0, size=(1, R))
        width = rng.uniform(15.0, 35.0, size=(1, R))
        ili += rng.uniform(0.5, 1.5, size=(1, R)) * np.exp(-0.5 * ((t - peak) / width) ** 2)
    ili = np.maximum(ili + rng.normal(0.0, 0.01, size=ili.shape), 0.0)
    ili /= ili.max(axis=0, keepdims=True)
    lead = rng.integers(0, 8, size=(R, Q))
    gain = rng.uniform(0.5, 1.5, size=(R, Q))
    idx = np.minimum(np.arange(days)[:, None, None] + lead[None], days - 1)
    q = gain[None] * ili[idx, np.arange(R)[None, :, None]]
    q += rng.normal(0.0, 0.05, size=q.shape)
    q -= q.min(axis=0, keepdims=True)
    q /= np.maximum(q.max(axis=0, keepdims=True), 1e-9)
    return np.concatenate([q.reshape(days, R * Q), ili], axis=1).astype(np.float32)


def windows(rng: np.random.Generator, n: int, cfg: Dict, mix: Dict,
            with_targets: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` windows x (n, window + lag, F) and targets y (n, window + horizon
    + 1, R) from consecutive days of one made-up series."""
    R, Q = cfg["n_regions"], cfg["n_qs"]
    w, lag, h = mix["window_days"], mix["lag_days"], mix["horizon_days"]
    span = max(w + lag, w + h + 1)
    s = series(rng, n + span, R, Q)
    view = np.lib.stride_tricks.sliding_window_view(s, w + lag, axis=0)[:n]
    x = np.ascontiguousarray(view.transpose(0, 2, 1))
    x[:, -lag:, R * Q:] = -1.0
    y = None
    if with_targets:
        yv = np.lib.stride_tricks.sliding_window_view(s[:, R * Q:], w + h + 1, axis=0)[:n]
        y = np.ascontiguousarray(yv.transpose(0, 2, 1))
    return x, y


def daily_points(mix: Dict) -> int:
    return mix["window_days"] + mix["horizon_days"] + 1


def weekly_points(mix: Dict) -> int:
    return mix["horizon_days"] // 7 + 1


def weights(cfg: Dict, seed: int, device) -> torch.Tensor:
    """Every parameter of the configuration end to end, (P,) float32, drawn on
    ``device`` in one call from a generator seeded with ``seed``."""
    specs = param_specs(cfg)
    counts = torch.tensor([math.prod(p.shape) for p in specs], device=device)
    lo = torch.tensor([p.lo for p in specs], dtype=torch.float32, device=device)
    hi = torch.tensor([p.hi for p in specs], dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(seed % SEED_MOD)
    u = torch.rand(int(counts.sum()), generator=g, device=device)
    return torch.repeat_interleave(lo, counts) + torch.repeat_interleave(hi - lo, counts) * u


@torch.no_grad()
def load_weights(model, cfg: Dict, flat: torch.Tensor) -> None:
    """Copy ``flat`` into the program's model by the parameters' names; every
    parameter of the model has to be one of the configuration's."""
    named = dict(model.named_parameters())
    mine = unflatten(flat, param_specs(cfg))
    if set(named) != set(mine):
        raise RuntimeError("the model's parameters are not the configuration's: "
                           f"{sorted(set(named) ^ set(mine))[:6]}")
    for name, t in mine.items():
        named[name].copy_(t)
