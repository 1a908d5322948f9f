"""Synthetic influenza-surveillance data with the reference's schemas.

Counterpart of ``fiude_tpu/data/synthetic.py:47-206`` (numpy only), kept as the
port's own copy: the reference's ``Data/`` directory is not in the repository,
so the experiment recipes train on fabricated, epidemiologically plausible
data.  :func:`synthetic_dataset` gives in-memory windowed training arrays
shaped like ``DataConstructor.__call__`` output (reference
``lib/regional_data_builder.py:162-274``).  The JAX package windows through a
C++ library (``data/native.py``); the port uses the numpy
:func:`build_windows`, which gives the same bits.  The writers of a fake
``Data/`` tree wait with ``DataConstructor`` (ROADMAP.md, queue A).

Epidemic curves come from actual SIR integrations (seasonally re-seeded,
noise-perturbed), so models trained on this data learn real mechanistic
structure, not arbitrary noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

def _sir_season(rng: np.random.Generator, n_days: int, beta: float,
                gamma: float, i0: float) -> np.ndarray:
    """Euler-integrated daily SIR infectious curve over one season (in weeks
    time units to match the model's t convention)."""
    s, i = 1.0 - i0, i0
    out = np.empty(n_days)
    dt_w = 1.0 / 7.0
    for d in range(n_days):
        out[d] = i
        ds = -beta * s * i
        di = beta * s * i - gamma * i
        s += ds * dt_w
        i += di * dt_w
    return out


def synthetic_daily_ili(
    n_regions: int,
    n_seasons: int = 6,
    season_len: int = 365,
    seed: int = 0,
    peak_scale: float = 7.7,
    season_coherence: float = 0.8,
) -> np.ndarray:
    """Daily ILI-rate curves (n_days, n_regions), peaks O(1-8) like CDC data.

    ``season_coherence`` in [0, 1] sets how strongly regions share each
    season's epidemic: real ILI surveillance co-moves across regions within
    a season (one dominant strain nationally — the property the reference's
    multi-region hhs/state results ride on), so each season draws shared
    (beta, gamma, i0, onset) "strain" parameters and each region perturbs
    them; at 0 every region draws its own season independently
    (which makes the synthetic hhs task strictly harder than the real data:
    10 nearly independent processes for one shared encoder).
    """
    rng = np.random.default_rng(seed)
    n_days = n_seasons * season_len
    ili = np.zeros((n_days, n_regions))
    c = float(np.clip(season_coherence, 0.0, 1.0))
    for s in range(n_seasons):
        beta_s = rng.uniform(0.7, 1.1)
        gam_s = rng.uniform(0.45, 0.6)
        i0_s = rng.uniform(5e-4, 3e-3)
        onset_s = rng.uniform(0.1, 0.35)
        for r in range(n_regions):
            beta = c * beta_s + (1 - c) * rng.uniform(0.7, 1.1) \
                + c * rng.normal(0.0, 0.03)
            gam = c * gam_s + (1 - c) * rng.uniform(0.45, 0.6) \
                + c * rng.normal(0.0, 0.015)
            i0 = c * i0_s + (1 - c) * rng.uniform(5e-4, 3e-3)
            i0 *= np.exp(c * rng.normal(0.0, 0.3))
            onset_f = c * onset_s + (1 - c) * rng.uniform(0.1, 0.35) \
                + c * rng.normal(0.0, 0.02)
            onset = int(np.clip(onset_f, 0.05, 0.5) * season_len)
            curve = _sir_season(rng, season_len, beta, gam, i0)
            seasonal = np.zeros(season_len)
            seasonal[onset:] = curve[: season_len - onset]
            ili[s * season_len:(s + 1) * season_len, r] += seasonal
    ili = ili / max(ili.max(), 1e-9) * peak_scale
    ili += np.abs(rng.normal(0.0, 0.02 * peak_scale, ili.shape))
    # weekly reporting smoothness
    kernel = np.ones(7) / 7.0
    for r in range(n_regions):
        ili[:, r] = np.convolve(ili[:, r], kernel, mode="same")
    return ili


def synthetic_queries(ili: np.ndarray, n_qs: int, seed: int = 0) -> np.ndarray:
    """Query time-series (n_days, n_regions, n_qs): lagged/saturated noisy
    transforms of ILI — informative like real search data."""
    rng = np.random.default_rng(seed + 1)
    n_days, n_regions = ili.shape
    qs = np.zeros((n_days, n_regions, n_qs))
    for r in range(n_regions):
        base = ili[:, r] / max(ili[:, r].max(), 1e-9)
        for q in range(n_qs):
            lag = rng.integers(-10, 3)
            shifted = np.roll(base, lag)
            gain = rng.uniform(0.4, 1.0)
            sat = rng.uniform(0.5, 2.0)
            noise = rng.normal(0, 0.05, n_days)
            qs[:, r, q] = np.clip(gain * shifted ** sat + noise, 0, None)
    qmax = qs.max(axis=0, keepdims=True)
    return qs / np.maximum(qmax, 1e-9)


def build_windows(
    qs_norm: np.ndarray,
    ili_norm: np.ndarray,
    *,
    window_size: int,
    gamma: int,
    lag: int = 14,
    run_backward: bool = True,
    no_qs_in_output: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows with the reference's exact layout
    (lib/regional_data_builder.py:219-251).

    Inputs: per step b, ``window_size + lag`` days of
    [region1 queries | region2 queries | ... | all-region ILI] with the
    trailing ``lag`` days of ILI masked to -1.
    Outputs: ILI over [lookback + horizon] when ``run_backward`` else horizon
    only.
    """
    n_days, n_regions, n_qs = qs_norm.shape
    inputs, outputs = [], []
    for b in range(window_size + 1, n_days - gamma):
        w_qs = qs_norm[b - window_size - 1: b + lag - 1]          # (W+lag, R, Q)
        w_ili = ili_norm[b - window_size - 1: b + lag - 1].copy()  # (W+lag, R)
        w_ili[-lag:, :] = -1.0
        # region-major query blocks like the reference's per-region concat
        feats = np.concatenate(
            [w_qs[:, r, :] for r in range(n_regions)] + [w_ili], axis=-1)

        if run_backward:
            o_ili = ili_norm[b - window_size - 1: b + gamma]
        else:
            o_ili = ili_norm[b: b + gamma]
        out = o_ili if no_qs_in_output else np.concatenate(
            [qs_norm[b: b + gamma, r, :] for r in range(n_regions)] + [o_ili],
            axis=-1)
        inputs.append(feats)
        outputs.append(out)
    return np.asarray(inputs, np.float32), np.asarray(outputs, np.float32)


def synthetic_dataset(
    *,
    n_regions: int = 1,
    n_qs: int = 4,
    window_size: int = 28,
    gamma: int = 28,
    lag: int = 14,
    n_seasons: int = 4,
    season_len: int = 200,
    train_frac: float = 0.8,
    run_backward: bool = True,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train, y_train, x_test, y_test, scaler) shaped like the reference
    DataConstructor output; scaler = ili.max() * 13 per region
    (lib/regional_data_builder.py:213)."""
    ili = synthetic_daily_ili(n_regions, n_seasons, season_len, seed)
    qs = synthetic_queries(ili, n_qs, seed)
    # the reference's scaler = ili.max()*13 un-does its /13 load scaling
    # (lib/regional_data_builder.py:140,213); synthetic curves are already in
    # raw wILI units, so the un-scaler is just the max
    scaler = ili.max(axis=0)
    ili_norm = ili / np.maximum(ili.max(axis=0, keepdims=True), 1e-9)
    x, y = build_windows(qs, ili_norm, window_size=window_size, gamma=gamma,
                         lag=lag, run_backward=run_backward)
    split = int(len(x) * train_frac)
    return (x[:split], y[:split], x[split:], y[split:],
            scaler.astype(np.float32))
