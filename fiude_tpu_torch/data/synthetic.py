"""Synthetic influenza-surveillance data with the reference's schemas.

Counterpart of ``fiude_tpu/data/synthetic.py:47-206`` (numpy only), kept as the
port's own copy: the reference's ``Data/`` directory is not in the repository,
so the experiment recipes train on fabricated, epidemiologically plausible
data.  :func:`synthetic_dataset` gives in-memory windowed training arrays
shaped like ``DataConstructor.__call__`` output (reference
``lib/regional_data_builder.py:162-274``).  The JAX package windows through a
C++ library (``data/native.py``); the port uses the builder's numpy
:func:`~fiude_tpu_torch.data.builder.stack_windows`, which gives the same bits.
:func:`write_reference_data_tree` writes a fake ``Data/`` tree in the
reference's layout, the files of ``fiude_tpu/data/synthetic.py:213-310``
from the same draws, through :mod:`fiude_tpu_torch.data.tables`, so that
:class:`~fiude_tpu_torch.data.builder.DataConstructor` can run end to end
where there is no pandas; :func:`write_legacy_national_tree` writes the
files of the legacy national pipeline (``fiude_tpu/data/synthetic.py:313-355``)
for :mod:`fiude_tpu_torch.data.legacy` the same way.

Epidemic curves come from actual SIR integrations (seasonally re-seeded,
noise-perturbed), so models trained on this data learn real mechanistic
structure, not arbitrary noise.
"""

from __future__ import annotations

import datetime as dt
import os
from typing import Tuple

import numpy as np

from fiude_tpu_torch.data.builder import stack_windows
from fiude_tpu_torch.data.regions import HHS_REGION_STATES, STATE_CODE_TO_NAME, STATE_CODES
from fiude_tpu_torch.data.tables import write_columns

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
    # window b's input rows [b-W-1, b+lag-1) of the region-major query blocks
    # and the ILI, the last lag days of ILI masked to -1; output ILI rows
    # [b-W-1 or b, b+gamma) (lib/regional_data_builder.py:219-251)
    b = np.arange(window_size + 1, qs.shape[0] - gamma)
    x = stack_windows([qs[:, r, :] for r in range(n_regions)] + [ili_norm],
                      b - window_size - 1, window_size + lag)
    x[:, -lag:, -n_regions:] = -1.0
    if run_backward:
        y = stack_windows([ili_norm], b - window_size - 1, window_size + 1 + gamma)
    else:
        y = stack_windows([ili_norm], b, gamma)
    split = int(len(x) * train_frac)
    return (x[:split], y[:split], x[split:], y[split:],
            scaler.astype(np.float32))


def write_reference_data_tree(root: str, *, n_qs: int = 12, seed: int = 0,
                              start: str = "2010-10-01", n_weeks: int = 470) -> None:
    """Write a fake ``Data/`` directory for
    :class:`~fiude_tpu_torch.data.builder.DataConstructor`: the files of the
    JAX package's writer (``fiude_tpu/data/synthetic.py:213-310``), from the
    same numpy draws, written as its pandas writes them (floats as ``repr``).

      - ``national_flu.csv``: weekly national ILI, ``weighted_ili``, ``week``,
        the date in the last column (``lib/regional_data_builder.py:128``)
      - ``hhs_flu.csv`` / ``state_flu.csv``: long rows (region,
        unweighted_ili, date), week by week (``:129-135``)
      - ``Queries/US_query_data_all_smoothed.csv`` and
        ``Queries/state_queries/{CODE}_query_data.csv``: daily query columns
        (FL too: it has queries and a population but no state ILI column)
      - ``state_population_data_2019.csv``: CODE, POP (``:34``)
      - ``Similarity_Scores.csv``: per-query semantic scores (``:107``)
      - ``Dates.csv``: per-season train/test split dates (``:253``)
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Queries", "state_queries"), exist_ok=True)

    start_date = dt.date.fromisoformat(start)
    week_dates = np.datetime64(start_date, "D") + 7 * np.arange(n_weeks)
    n_days = (n_weeks - 1) * 7 + 1
    day_dates = week_dates[0] + np.arange(n_days)
    names = [STATE_CODE_TO_NAME[c] for c in STATE_CODES]

    n_states = len(STATE_CODES)
    season_len = 364
    n_seasons = n_days // season_len + 1
    state_ili = synthetic_daily_ili(n_states, n_seasons, season_len, seed)[:n_days]
    nat_ili = state_ili.mean(axis=1, keepdims=True)
    q_names = [f"query_{i}" for i in range(n_qs)]

    widx = 7 * np.arange(n_weeks)
    write_columns(os.path.join(root, "national_flu.csv"), ["weighted_ili", "week", "date"],
                  [nat_ili[widx, 0], np.arange(n_weeks), week_dates])

    # long format, week by week: every state, then every HHS region
    hhs_names = [f"Region {num}" for num in HHS_REGION_STATES]
    members = [[STATE_CODES.index(c) for c in codes if c in STATE_CODES]
               for codes in HHS_REGION_STATES.values()]
    hhs_ili = np.array([[state_ili[w, m].mean() for m in members] for w in widx])
    for path, labels, table in (("hhs_flu.csv", hhs_names, hhs_ili),
                                ("state_flu.csv", names, state_ili[widx])):
        write_columns(os.path.join(root, path), ["region", "unweighted_ili", "date"],
                      [np.tile(labels, n_weeks), table.reshape(-1),
                       np.repeat(week_dates, len(labels))])

    query_codes = STATE_CODES + ["FL"]
    for i, code in enumerate(query_codes):
        col = state_ili[:, i:i + 1] if i < n_states else state_ili[:, 9:10]
        qs = synthetic_queries(col, n_qs, seed + i)[:, 0, :] * 100.0
        write_columns(os.path.join(root, "Queries", "state_queries", f"{code}_query_data.csv"),
                      ["", *q_names], [day_dates, *qs.T])
    qs = synthetic_queries(nat_ili, n_qs, seed + 999)[:, 0, :] * 100.0
    write_columns(os.path.join(root, "Queries", "US_query_data_all_smoothed.csv"),
                  ["", *q_names], [day_dates, *qs.T])

    pops = rng.integers(500_000, 40_000_000, len(query_codes))
    write_columns(os.path.join(root, "state_population_data_2019.csv"), ["", "CODE", "POP"],
                  [np.arange(len(query_codes)), query_codes, pops])
    write_columns(os.path.join(root, "Similarity_Scores.csv"), ["", "similarity"],
                  [q_names, rng.uniform(0.3, 1.0, n_qs)])

    first_year = start_date.year
    last_year = int(str(week_dates[-1])[:4])
    seasons = list(range(first_year + 2, last_year))
    write_columns(os.path.join(root, "Dates.csv"),
                  ["season", "train_start", "train_end", "test_start", "test_end"],
                  [seasons, [f"{first_year}-11-01"] * len(seasons),
                   [f"{s}-08-01" for s in seasons], [f"{s}-10-01" for s in seasons],
                   [f"{s + 1}-05-01" for s in seasons]])


def write_legacy_national_tree(root: str, *, n_qs: int = 6, seed: int = 0) -> None:
    """Write the files the legacy national pipeline reads
    (:mod:`fiude_tpu_torch.data.legacy`, reference ``lib/Old/data.py:15-74``):
    the JAX package's writer's files (``fiude_tpu/data/synthetic.py:313-355``),
    from the same draws, byte for byte.

      - ``national_flu.csv``: weekly US ILI on Sundays from 1997-01-05 to
        2017-07-30 (the reference skips the first 300 rows, ``:66``), so the
        +3-day shift lands on the Wednesday season anchors
      - ``ILI_rates_{UK,US}_thursday_cubic_interpolation.csv``: daily
        national ILI from 2003-06-01 to 2017-06-30, column ``wILI``
      - ``{UK,US}_Qs_small_7day_avg.csv``: daily national query columns
      - ``{UK,US}_Similarity_Scores.csv``: per-query semantic scores
    """
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    q_names = [f"query_{i}" for i in range(n_qs)]

    first, last = np.datetime64("1997-01-05", "D"), np.datetime64("2017-07-30", "D")
    week_dates = first + 7 * np.arange(int((last - first) // np.timedelta64(7, "D")) + 1)
    n_seasons = len(week_dates) // 52 + 1
    daily_curve = synthetic_daily_ili(1, n_seasons, 364, seed)[:, 0]
    write_columns(os.path.join(root, "national_flu.csv"), ["weighted_ili", "week", "date"],
                  [daily_curve[7 * np.arange(len(week_dates))], np.arange(len(week_dates)),
                   week_dates])

    day_dates = np.arange(np.datetime64("2003-06-01", "D"), np.datetime64("2017-07-01", "D"))
    for code, shift in (("UK", 0), ("US", 1)):
        curve = synthetic_daily_ili(1, len(day_dates) // 364 + 1, 364,
                                    seed + shift)[: len(day_dates), 0]
        write_columns(os.path.join(root, f"ILI_rates_{code}_thursday_cubic_interpolation.csv"),
                      ["", "wILI"], [day_dates, curve])
        qs = synthetic_queries(curve[:, None], n_qs, seed + 10 + shift)[:, 0, :] * 100.0
        write_columns(os.path.join(root, f"{code}_Qs_small_7day_avg.csv"), ["", *q_names],
                      [day_dates, *qs.T])
        write_columns(os.path.join(root, f"{code}_Similarity_Scores.csv"), ["", "similarity"],
                      [q_names, rng.uniform(0.3, 1.0, n_qs)])
