"""ILI + search-query data pipeline (reference ``lib/regional_data_builder.py``).

Counterpart of ``fiude_tpu/data/builder.py:41-272`` with numpy, scipy and the
``csv`` module (:mod:`fiude_tpu_torch.data.tables`) where the JAX package
uses pandas, which the card's machine does not have.  The tables are
:class:`~fiude_tpu_torch.data.tables.Frame` (a date index and float
columns) instead of DataFrames, and :class:`DataConstructor` returns the
same ``(x_train, y_train, x_test, y_test, scaler)``, bit for bit, with
``scaler`` a float64 array of shape ``(R,)`` where the reference returns a
Series.  What pandas decides is kept as it behaves:

* :func:`load_ili` (``hhs``/``state``): regions in order of first
  appearance; the first region's dates are the index, later regions align to
  them by date, gaps are 0;
* :func:`get_hhs_query_data`: the member weights count ignored members in
  the total population; columns and dates are those every member has, in the
  first member's order; the weighted sum starts at 0.0 and adds in member
  order;
* :func:`smooth`: the mean over the stacked shifts, indexed from day ``n``;
* :func:`choose_qs`: queries with zero std (ddof 1, pandas' two-pass
  formula) over the three seasons before the test season dropped; the
  correlations joined with ``Similarity_Scores.csv`` by query name, rows with
  a missing value dropped; each column min-max normalised and taken from 1;
  the score the root of the sum of squares; the order numpy's quicksort of
  the scores in the file's row order (how pandas' ``sort_values`` breaks
  ties);
* :func:`interpolate_ili`: cubic ``interp1d`` over ``linspace`` positions,
  not dates; with ``fill_1`` the daily rows between the weekly points NaN;
* :class:`DataConstructor`: queries divided by their full-series max, the
  ILI sliced to the last region's query dates, the windows positional over
  both tables, each window dated by its output slice, the split from
  ``Dates.csv`` (a missing ``train_start`` means 0).

The legacy national pipeline (``England``, ``data/legacy.py``) is a later
slice of the port (ROADMAP.md, queue A, item 3).
"""

from __future__ import annotations

import datetime as dt
import os
from typing import Dict, Sequence, Tuple

import numpy as np
from scipy import interpolate
from scipy.stats import pearsonr

from fiude_tpu_torch.data.regions import (
    HHS_REGION_STATES, N_REGIONS, STATE_CODE_TO_NAME, STATE_CODES, STATE_NAMES,
)
from fiude_tpu_torch.data.tables import Frame, dates_of, floats_of, read_columns, read_frame

_ILI_FILES = {"US": "national_flu.csv", "state": "state_flu.csv", "hhs": "hhs_flu.csv"}
_DAY = np.timedelta64(1, "D")


def smooth(frame: Frame, n: int = 7) -> Frame:
    """Trailing n-day moving average (reference :15-19): the mean of the n
    shifted copies, the result indexed from day ``n``."""
    v = frame.values
    data = np.mean(np.asarray([v[i: -(n - i)] for i in range(n)]), 0)
    return Frame(frame.index[n:], frame.columns, data)


def get_state_query_data(num: int, root: str = "Data/",
                         append: str = "Queries/state_queries",
                         smooth_after: bool = False) -> Frame:
    code = STATE_CODES[num - 1]
    frame = read_frame(os.path.join(root, append, f"{code}_query_data.csv"))
    return smooth(frame) if smooth_after else frame


def _population(root: str) -> Dict[str, float]:
    """State code -> population, from the first row of each code."""
    path = os.path.join(root, "state_population_data_2019.csv")
    header, columns = read_columns(path)
    codes = columns[header.index("CODE")]
    pops = floats_of(columns[header.index("POP")], f"{path}, column 'POP'")
    out: Dict[str, float] = {}
    for code, pop in zip(codes, pops):
        out.setdefault(code, float(pop))
    return out


def _common(frames: Sequence[Frame]) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """The dates and columns that every frame has, in the first frame's order."""
    dates, cols = frames[0].index, frames[0].columns
    for f in frames[1:]:
        dates = dates[np.isin(dates, f.index)]
        cols = tuple(c for c in cols if c in f.columns)
    return dates, cols


def _at(frame: Frame, dates: np.ndarray, cols: Sequence[str]) -> np.ndarray:
    """``frame.loc[dates, cols]`` for dates and columns it has (a date that
    is there twice raises, as pandas' reindex does)."""
    order = np.argsort(frame.index, kind="stable")
    pos = order[np.searchsorted(frame.index, dates, sorter=order)]
    if len(np.unique(frame.index)) != len(frame.index):
        raise ValueError("cannot align a table whose dates repeat")
    return frame.select(cols).values[pos]


def get_hhs_query_data(num: int, root: str = "Data/",
                       append: str = "Queries/state_queries",
                       ignore: Sequence[str] = (),
                       smooth_after: bool = False) -> Frame:
    """Population-weighted sum of member-state query series (reference :33-75)."""
    pop = _population(root)
    members = HHS_REGION_STATES[num]
    total = 0
    for code in members:              # ignored members count in the total too
        total = total + pop[code]
    weighted = []
    for code in members:
        if code in ignore:
            continue
        f = read_frame(os.path.join(root, append, f"{code}_query_data.csv"))
        weighted.append(Frame(f.index, f.columns, (pop[code] / total) * f.values))
    dates, cols = _common(weighted)
    out = np.zeros((len(dates), len(cols)))
    for f in weighted:
        out = out + _at(f, dates, cols)
    frame = Frame(dates, cols, out)
    return smooth(frame) if smooth_after else frame


def get_nat_query_data(num: int, root: str = "Data/",
                       smooth_after: bool = False) -> Frame:
    """The national query table (already smoothed on disk: ``smooth_after``
    is ignored, as in the reference)."""
    return read_frame(os.path.join(root, "Queries", "US_query_data_all_smoothed.csv"))


def _ili_column(daily_ili: Frame, region_num: int, region: str) -> np.ndarray:
    if region == "US":
        return daily_ili.column("weighted_ili")
    if region == "hhs":
        return daily_ili.column("Region " + str(region_num))
    return daily_ili.column(STATE_NAMES[region_num - 1])


def _std_is_zero(q: np.ndarray) -> np.ndarray:
    """Per column, whether pandas' ``DataFrame.std()`` (ddof 1, two-pass:
    the mean from the sum, then the squared deviations summed) is 0."""
    avg = q.sum(axis=0) / q.shape[0]
    var = ((avg - q) ** 2).sum(axis=0) / (q.shape[0] - 1)
    return np.sqrt(var) == 0


def choose_qs(qs_data_dict: Dict[int, Frame], daily_ili: Frame, region_num: int,
              season: int, n_qs: int, region: str = "hhs",
              root: str = "Data/") -> Tuple[str, ...]:
    """Top-n query selection by correlation+similarity distance (reference
    :83-120): the names of the ``n_qs`` best queries, best first."""
    queries = qs_data_dict[region_num]
    ili = _ili_column(daily_ili, region_num, region)
    keep_q = np.isin(queries.index, daily_ili.index)
    q_dates = queries.index[keep_q]
    q_vals = queries.values[keep_q]
    ili = ili[np.isin(daily_ili.index, q_dates)]

    first = np.datetime64(dt.date(season - 3, 10, 3), "D")
    last = np.datetime64(dt.date(season, 10, 1), "D")
    window = (q_dates >= first) & (q_dates <= last)
    q_win, ili_win = q_vals[window], ili[window]
    kept = ~_std_is_zero(q_win)
    names = [c for c, k in zip(queries.columns, kept) if k]
    corr = dict(zip(names, (pearsonr(ili_win, q)[0] for q in q_win[:, kept].T)))

    sim = read_frame(os.path.join(root, "Similarity_Scores.csv"), parse_dates=False)
    correlation = [corr.get(q, np.nan) for q in sim.index]
    if "correlation" in sim.columns:     # the join replaces a column of that name
        table = sim.values.copy()
        table[:, sim.columns.index("correlation")] = correlation
    else:
        table = np.column_stack([sim.values, correlation])
    rows = ~np.isnan(table).any(axis=1)
    table, index = table[rows], sim.index[rows]
    for j in range(table.shape[1]):
        col = table[:, j] - table[:, j].min()
        denom = col.max()
        table[:, j] = 1 - col / (denom if denom != 0 else 1.0)
    sq = np.square(table)
    score = sq[:, 0]
    for j in range(1, sq.shape[1]):
        score = score + sq[:, j]
    order = np.argsort(np.sqrt(score), kind="quicksort")
    return tuple(str(q) for q in index[order][:n_qs])


def load_ili(location: str, root: str = "Data/") -> Frame:
    """Load the weekly ILI table (reference :122-147), divided by 13."""
    if location not in _ILI_FILES:
        raise ValueError(
            f"unknown location {location!r}; the regional pipeline reads "
            f"{sorted(_ILI_FILES)} (the England tables are the legacy pipeline, "
            "not ported yet: ROADMAP.md, queue A, item 3)")
    path = os.path.join(root, _ILI_FILES[location])
    header, columns = read_columns(path)
    dates = dates_of(columns[-1], path)
    if location == "US":
        ili = floats_of(columns[header.index("weighted_ili")], f"{path}, column 'weighted_ili'")
        return Frame(dates, ("weighted_ili",), ili[:, None] / 13.0)
    regions = np.asarray(columns[header.index("region")], dtype=object)
    ili = floats_of(columns[header.index("unweighted_ili")], f"{path}, column 'unweighted_ili'")
    names = list(dict.fromkeys(regions.tolist()))
    index = dates[regions == names[0]]
    wide = np.full((len(index), len(names)), np.nan)
    for j, name in enumerate(names):
        rows = regions == name
        if j == 0:
            wide[:, 0] = ili[rows]
            continue
        d = dates[rows]
        if len(np.unique(d)) != len(d):
            raise ValueError(f"{path}: region {name!r} has a date twice")
        found = np.isin(index, d)
        order = np.argsort(d, kind="stable")
        wide[found, j] = ili[rows][order[np.searchsorted(d, index[found], sorter=order)]]
    wide = wide / 13.0
    return Frame(index, tuple(names), np.where(np.isnan(wide), 0.0, wide))


def interpolate_ili(ili: Frame, fill_1: bool = False) -> Frame:
    """Weekly -> daily cubic interpolation; ``fill_1`` keeps the weekly
    values on the daily index with NaN between them (reference :149-160)."""
    n_days = int((ili.index[-1] - ili.index[0]) // _DAY) + 1
    dates = ili.index[0] + np.arange(n_days) * _DAY
    if fill_1:
        out = np.full((n_days, len(ili.columns)), np.nan)
        out[((ili.index - ili.index[0]) // _DAY).astype(int)] = ili.values
        return Frame(dates, ili.columns, out)
    x = np.linspace(0, 1, ili.values.shape[0])
    x2 = np.linspace(0, 1, n_days)
    f = interpolate.interp1d(x, ili.values, axis=0, kind="cubic")
    return Frame(dates, ili.columns, f(x2))


def _check_rows(tables, starts: np.ndarray, length: int) -> None:
    """Raise if a table is too short for a window, as the reference's
    concatenation of its ``iloc`` slices does."""
    for t in tables:
        if len(starts) and starts[-1] + length > t.shape[0]:
            raise ValueError(f"a table of {t.shape[0]} rows is too short for the windows "
                             f"(row {starts[-1] + length - 1} needed)")


def stack_windows(tables, starts: np.ndarray, length: int) -> np.ndarray:
    """float32 windows ``[t[s:s+length] for t in tables]`` joined along the
    features, one a start (ascending): positional on each table, as the
    reference's ``iloc``.  The one windowing routine of the port: the
    builder's and :func:`~fiude_tpu_torch.data.synthetic.synthetic_dataset`'s."""
    _check_rows(tables, starts, length)
    rows = starts[:, None] + np.arange(length)[None, :]
    return np.concatenate([t.astype(np.float32)[rows] for t in tables], axis=-1)


def _split(root: str, season: int, dates: np.ndarray) -> Tuple[int, int, int, int]:
    """The window positions of a season's train/test start and end dates
    (``Dates.csv``); a ``train_start`` that no window has means 0."""
    path = os.path.join(root, "Dates.csv")
    header, columns = read_columns(path)
    seasons = [int(s) for s in columns[0]]
    if season not in seasons:
        raise KeyError(f"{path}: no season {season}")
    row = seasons.index(season)

    def at(name, default=None):
        day = np.datetime64(dt.datetime.strptime(columns[header.index(name)][row],
                                                 "%Y-%m-%d").date(), "D")
        hit = np.nonzero(dates == day)[0]
        if len(hit):
            return int(hit[0])
        if default is None:
            raise ValueError(f"{path}: season {season}'s {name} {day} is no window's date")
        return default

    return at("train_start", 0), at("train_end"), at("test_start"), at("test_end")


class DataConstructor:
    """End-to-end dataset builder (reference :162-274).

    ``__call__(run_backward, no_qs_in_output)`` returns
    ``(x_train, y_train, x_test, y_test, scaler)``: float32 windows and the
    float64 ``scaler`` (R,).
    """

    def __init__(self, test_season: int, region: str = "hhs",
                 n_queries: int = 10, gamma: int = 28, window_size: int = 28,
                 lag: int = 14, fill_1: bool = False, root: str = "Data/",
                 ignore: Sequence[str] = ("VI", "PR")):
        if region not in N_REGIONS:
            raise ValueError(
                f"region {region!r} is not a regional pipeline ({sorted(N_REGIONS)}); the "
                "England pipeline is the legacy one, not ported yet (ROADMAP.md, queue A, "
                "item 3)")
        self.test_season = test_season
        self.region = region
        self.n_queries = n_queries
        self.gamma = gamma
        self.window_size = window_size
        self.lag = lag
        self.fill_1 = fill_1
        self.root = root
        self.ignore = list(ignore)
        self.n_regions = N_REGIONS[region]

    def _queries(self, i: int) -> Frame:
        if self.region == "US":
            return get_nat_query_data(i, self.root)
        if self.region == "hhs":
            return get_hhs_query_data(i, self.root, ignore=self.ignore, smooth_after=True)
        return get_state_query_data(i, self.root, smooth_after=True)

    def __call__(self, run_backward: bool = False, no_qs_in_output: bool = False):
        root, R = self.root, self.n_regions
        ili = interpolate_ili(load_ili(self.region, root), fill_1=False)
        qs_data: Dict[int, Frame] = {}
        for i in range(1, 1 + R):
            qs_data[i] = self._queries(i)
            names = choose_qs(qs_data, ili, i, self.test_season - 1, self.n_queries,
                              region=self.region, root=root)
            q = qs_data[i].select(names)
            qs_data[i] = Frame(q.index, q.columns, q.values / np.nanmax(q.values, axis=0))

        ili = interpolate_ili(load_ili(self.region, root), fill_1=self.fill_1)
        last = qs_data[R].index
        ili = ili.rows((ili.index >= last[0]) & (ili.index <= last[-1]))
        if self.region == "state":
            ili = ili.select([STATE_CODE_TO_NAME[c] for c in STATE_CODES])
        peak = np.nanmax(ili.values, axis=0)
        scaler = peak * 13.0
        values = ili.values / peak
        if self.fill_1:
            values = np.where(np.isnan(values), -1.0, values)

        # window b's input rows [b-W-1, b+lag-1), output rows [b-W-1 or b, b+gamma)
        W, n = self.window_size, values.shape[0]
        b = np.arange(W + 1, n - self.gamma)
        out_lo = b - W - 1 if run_backward else b
        dates = ili.index[out_lo] - _DAY
        train_start, train_end, test_start, test_end = _split(root, self.test_season, dates)

        queries = [qs_data[i].values for i in range(1, R + 1)]
        out_len = W + 1 + self.gamma if run_backward else self.gamma

        def windows(sel):
            lo_in, lo_out = b[sel] - W - 1, out_lo[sel]
            ins = stack_windows(queries + [values], lo_in, W + self.lag)
            ins[:, -self.lag:, -R:] = -1.0
            # the reference joins the queries to the outputs before it drops
            # them: a query table too short for that raises either way
            _check_rows(queries, lo_out, out_len)
            outs = stack_windows([values] if no_qs_in_output else queries + [values],
                            lo_out, out_len)
            return ins, outs

        x_train, y_train = windows(slice(train_start, train_end))
        x_test, y_test = windows(slice(test_start, test_end))
        return x_train, y_train, x_test, y_test, scaler
