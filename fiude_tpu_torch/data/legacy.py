"""Legacy national (single-region) data pipeline: England and US.

Counterpart of ``fiude_tpu/data/legacy.py:36-179`` (reference
``lib/Old/data.py:15-114``, the only England end-to-end path of the
reference) with numpy and :mod:`fiude_tpu_torch.data.tables` where the JAX
package uses pandas.  The arrays are the JAX package's bit for bit; what
pandas decides there implicitly is done here on purpose:

* :func:`load_legacy_queries` (``:15-40``):
  - the query table's header deduplicated as ``pd.read_csv`` mangles it
    (a repeated name ``q`` becomes ``q.1``, ``q.2``, ...);
  - rows of a repeated date dropped but the first, then sorted by date;
  - ``+`` and ``,`` turned into spaces, then the words sorted; of columns
    whose new names collide, the first kept;
  - rows that are all NaN dropped, then columns whose max is 0 (a column
    that is all NaN has max NaN and is kept: pandas' max skips NaN);
  - each query's Pearson correlation with ``wILI`` over the dates that the
    query table, the ILI table and the three years before the season have
    in common, over the rows where both are present (``corrwith``:
    ``np.corrcoef(ili, query)[0, 1]``), divided by the largest correlation;
    the similarity scores divided by their column's max; the rating the
    root of the sum of their squares;
  - the queries in descending order of rating, NaN last, ties as pandas'
    ``nargsort`` breaks them (numpy's quicksort over the reversed ratings);
  - the rows those of the dates the ILI table and the query table share.
* :func:`legacy_national_data` (``:43-114``): weekly windows anchored on
  per-season dates (``LEGACY_TEST_DATES``); a window is the label slice
  ``[anchor - window weeks, anchor + extra]`` of a date-sorted table, both
  ends included, the anchors every week from a season's start to its end,
  the end included when it is on the grid.  England's weekly series is every
  7th row of the daily table, the US one ``national_flu.csv`` from row 300;
  both are dated +3 days; US training windows drop their last row.  Windows
  of unequal length raise ``ValueError``, as ``np.asarray`` does in the JAX
  package: nothing is padded.  The query windows reach ``lag`` days past the
  anchor, each column divided by its max.

Returns plain arrays: feed them to
:class:`~fiude_tpu_torch.data.loader.ArrayLoader` for batching.
"""

from __future__ import annotations

import datetime as dt
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fiude_tpu_torch.data.tables import (
    Frame, dates_of, floats_of, nanmax, read_columns, read_frame,
)

#: per-season window anchors (reference lib/Old/data.py:45-60):
#: [train_start, train_end, test_start, test_end]
LEGACY_TEST_DATES = {
    2004: [dt.date(2004, 3, 24), dt.date(2004, 8, 12), dt.date(2004, 10, 19), dt.date(2005, 5, 14)],
    2005: [dt.date(2004, 3, 24), dt.date(2005, 8, 11), dt.date(2005, 10, 19), dt.date(2006, 5, 14)],
    2006: [dt.date(2004, 3, 24), dt.date(2006, 8, 16), dt.date(2006, 10, 19), dt.date(2007, 5, 14)],
    2007: [dt.date(2004, 3, 24), dt.date(2007, 8, 15), dt.date(2007, 10, 19), dt.date(2008, 5, 14)],
    2008: [dt.date(2004, 3, 24), dt.date(2008, 8, 14), dt.date(2008, 10, 19), dt.date(2009, 5, 14)],
    2009: [dt.date(2004, 3, 24), dt.date(2009, 8, 13), dt.date(2009, 10, 19), dt.date(2010, 5, 14)],
    2010: [dt.date(2004, 3, 24), dt.date(2010, 8, 12), dt.date(2010, 10, 19), dt.date(2011, 5, 14)],
    2011: [dt.date(2004, 3, 24), dt.date(2011, 8, 11), dt.date(2011, 10, 19), dt.date(2012, 5, 14)],
    2012: [dt.date(2004, 3, 24), dt.date(2012, 8, 16), dt.date(2012, 10, 19), dt.date(2013, 5, 14)],
    2013: [dt.date(2004, 3, 24), dt.date(2013, 8, 15), dt.date(2013, 10, 19), dt.date(2014, 5, 14)],
    2014: [dt.date(2004, 3, 24), dt.date(2014, 8, 14), dt.date(2014, 10, 19), dt.date(2015, 5, 14)],
    2015: [dt.date(2004, 3, 24), dt.date(2015, 8, 13), dt.date(2015, 11, 1),  dt.date(2016, 4, 17)],
    2016: [dt.date(2004, 3, 24), dt.date(2016, 8, 11), dt.date(2016, 10, 29), dt.date(2017, 4, 16)],
    2017: [dt.date(2004, 3, 24), dt.date(2017, 8, 10), dt.date(2017, 10, 28), dt.date(2018, 4, 15)],
    2018: [dt.date(2004, 3, 24), dt.date(2018, 8, 9),  dt.date(2018, 10, 27), dt.date(2019, 4, 14)],
}

_DAY = np.timedelta64(1, "D")


def _country_code(country: str) -> str:
    return "UK" if country == "England" else "US"


def _day(d) -> np.datetime64:
    return np.datetime64(d, "D")


def _dedup(names: Sequence[str]) -> List[str]:
    """A header's names as ``pd.read_csv`` gives them: the k-th repeat of a
    name gets ``.k`` (and so on while that name is taken too)."""
    out, counts = [], {}
    for name in names:
        n = counts.get(name, 0)
        while n > 0:
            counts[name] = n + 1
            name = f"{name}.{n}"
            n = counts.get(name, 0)
        out.append(name)
        counts[name] = n + 1
    return out


def _first_of_each(keys: Sequence) -> np.ndarray:
    """The positions of the first occurrence of each key, in order."""
    seen, keep = set(), []
    for i, k in enumerate(keys):
        if k not in seen:
            seen.add(k)
            keep.append(i)
    return np.asarray(keep, dtype=np.int64)


def _label_slice(index: np.ndarray, lo, hi, where: str) -> slice:
    """``.loc[lo:hi]`` on a date index sorted ascending: both ends included."""
    if len(index) > 1 and (np.diff(index) < np.timedelta64(0, "D")).any():
        raise ValueError(f"{where}: the dates are not sorted ascending")
    return slice(int(np.searchsorted(index, lo, "left")),
                 int(np.searchsorted(index, hi, "right")))


def _week_range(start, end) -> np.ndarray:
    """``pd.date_range(start, end, freq=1 week)``: the end included when on
    the grid."""
    start, end = _day(start), _day(end)
    if end < start:
        return np.empty(0, "datetime64[D]")
    return start + 7 * np.arange(int((end - start) // np.timedelta64(7, "D")) + 1)


def _stack(windows: List[np.ndarray], what: str) -> np.ndarray:
    """float32 windows stacked; windows of unequal length raise."""
    lengths = sorted({len(w) for w in windows})
    if len(lengths) > 1:
        raise ValueError(f"{what}: windows of unequal length {lengths} (a date range "
                         "the table does not cover)")
    return np.asarray(windows, np.float32)


def load_legacy_queries(root: str, data_season: int, country: str = "England",
                        n_queries: int = 100) -> Frame:
    """Clean and rank the national query table (reference lib/Old/data.py:15-40):
    the ``n_queries`` best queries, best first, on the dates the ILI table
    and the query table share (the module docstring gives the rules).

    Expects under ``root``:
      ``ILI_rates_{code}_thursday_cubic_interpolation.csv`` (daily, 'wILI'),
      ``{code}_Qs_small_7day_avg.csv`` (daily query columns),
      ``{code}_Similarity_Scores.csv`` (per-query similarity; write one
      with :func:`fiude_tpu_torch.data.embedding.build_similarity_scores`).
    """
    code = _country_code(country)
    ili = read_frame(os.path.join(root, f"ILI_rates_{code}_thursday_cubic_interpolation.csv"))
    qs = read_frame(os.path.join(root, f"{code}_Qs_small_7day_avg.csv"))
    qs = Frame(qs.index, tuple(_dedup(qs.columns)), qs.values)

    keep = _first_of_each(qs.index.tolist())
    keep = keep[np.argsort(qs.index[keep], kind="stable")]
    index, values = qs.index[keep], qs.values[keep]
    names = [" ".join(sorted(q.replace("+", " ").replace(",", " ").split(" ")))
             for q in qs.columns]
    cols = _first_of_each(names)
    names, values = [names[j] for j in cols], values[:, cols]
    rows = ~np.isnan(values).all(axis=1)
    index, values = index[rows], values[rows]
    cols = np.nonzero(nanmax(values, axis=0) != 0)[0]
    names, values = [names[j] for j in cols], values[:, cols]

    first, last = _day(dt.date(data_season - 3, 1, 1)), _day(dt.date(data_season, 1, 1))
    window = np.intersect1d(index[(index >= first) & (index <= last)], ili.index)
    if np.isin(ili.index, window).sum() != len(window):
        raise ValueError(f"{code} ILI table: a date of the comparison window is there twice")
    order = np.argsort(ili.index, kind="stable")
    ili_w = ili.column("wILI")[order[np.searchsorted(ili.index, window, sorter=order)]]
    q_w = values[np.searchsorted(index, window)]
    corr = np.full(len(names), np.nan)
    for j in range(len(names)):
        valid = ~np.isnan(ili_w) & ~np.isnan(q_w[:, j])
        if valid.any():
            with np.errstate(invalid="ignore", divide="ignore"):
                corr[j] = np.corrcoef(ili_w[valid], q_w[valid, j])[0, 1]

    sim = read_frame(os.path.join(root, f"{code}_Similarity_Scores.csv"), parse_dates=False)
    corr = corr / nanmax(corr)
    sim_first = sim.values[:, 0] / nanmax(sim.values[:, 0])
    sim_names = sim.index.tolist()
    missing = [q for q in names if q not in sim_names]
    if missing:
        raise KeyError(f"{code}_Similarity_Scores.csv has no rows {missing}")
    if len(set(sim_names)) != len(sim_names):
        raise ValueError(f"{code}_Similarity_Scores.csv: a query is there twice")
    s = sim_first[[sim_names.index(q) for q in names]]
    rating = np.sqrt(np.square(corr) + np.square(s))

    # pandas' nargsort, descending, NaN last
    nan = np.isnan(rating)
    pos = np.arange(len(rating))[~nan][::-1]
    order = pos[rating[~nan][::-1].argsort(kind="quicksort")][::-1]
    order = np.concatenate([order, np.nonzero(nan)[0]])
    selected = [names[j] for j in order][:n_queries]

    common = np.intersect1d(ili.index, index)
    picked = [names.index(q) for q in selected]
    return Frame(common, tuple(selected), values[np.searchsorted(index, common)][:, picked])


def _weekly_ili(root: str, country: str) -> Frame:
    """The weekly national ILI, dated +3 days (reference :62-76)."""
    if country == "England":
        path = os.path.join(root, "ILI_rates_UK_thursday_cubic_interpolation.csv")
        daily = read_frame(path)
        n_days = len(daily.index) // 7 * 7
        index = daily.index[:n_days].reshape(-1, 7)[:, 0]
        data = daily.values[:n_days].reshape(-1, 7)[:, 0]
        if data.shape != index.shape:
            raise ValueError(f"{path}: the daily table must have one column, has "
                             f"{len(daily.columns)}")
    else:
        path = os.path.join(root, "national_flu.csv")
        header, columns = read_columns(path)
        index = dates_of(columns[-1], path)[300:]
        data = floats_of(columns[header.index("weighted_ili")],
                         f"{path}, column 'weighted_ili'")[300:]
    return Frame(index + 3 * _DAY, ("weighted_ili",), data[:, None])


def legacy_national_data(
    root: str = "Data/",
    *,
    country: str = "England",
    window: int = 12,
    gamma: int = 6,
    year: int = 2016,
    data_season: int = 2015,
    n_queries: int = 0,
    lag: int = 14,
    rescale: Optional[bool] = None,
) -> Tuple:
    """Weekly national windows (reference lib/Old/data.py:43-114).

    Returns ``(x_train, y_train, x_test, y_test, ili_max)``; with
    ``n_queries > 0``, ``(x_train, y_train, x_test, y_test, q_train,
    q_test, ili_max)``: float32 arrays and a float.  Window rows are weekly;
    x spans ``window`` lookback weeks, y ``gamma`` forecast weeks more.
    """
    if year not in LEGACY_TEST_DATES:
        raise ValueError(f"no legacy season anchors for year {year}; "
                         f"options: {sorted(LEGACY_TEST_DATES)}")
    anchors = LEGACY_TEST_DATES[year]
    ili = _weekly_ili(root, country)
    ili_max = float(ili.values.max())
    values = ili.values / ili_max if rescale else ili.values

    def windows(start, end, extra_weeks=0):
        out = []
        for date in _week_range(start, end):
            rows = _label_slice(ili.index, date - 7 * window * _DAY,
                                date + 7 * extra_weeks * _DAY, "the weekly ILI")
            out.append(values[rows])
        return _stack(out, f"{country} ILI windows")

    x_tr = windows(anchors[0], anchors[1])
    x_te = windows(anchors[2], anchors[3])
    y_tr = windows(anchors[0], anchors[1], extra_weeks=gamma)
    y_te = windows(anchors[2], anchors[3], extra_weeks=gamma)
    if country != "England":
        # reference :93-95 trims the inclusive slice's extra row off the
        # training arrays (the US weekly index aligns with the anchors)
        x_tr = x_tr[:, :-1, :]
        y_tr = y_tr[:, :-1, :]

    if n_queries == 0:
        return x_tr, y_tr, x_te, y_te, ili_max

    qs = load_legacy_queries(root, data_season, country, n_queries=n_queries)
    q_values = qs.values / np.tile(nanmax(qs.values, axis=0), (qs.values.shape[0], 1))
    rows = _label_slice(qs.index, ili.index[0], ili.index[-1], "the query table")
    q_index, q_values = qs.index[rows], q_values[rows]

    def q_windows(start, end):
        out = []
        for date in _week_range(start, end):
            rows = _label_slice(q_index, date - 7 * window * _DAY, date + lag * _DAY,
                                "the query table")
            out.append(q_values[rows])
        return _stack(out, f"{country} query windows")

    q_tr = q_windows(anchors[0], anchors[1])
    q_te = q_windows(anchors[2], anchors[3])
    return x_tr, y_tr, x_te, y_te, q_tr, q_te, ili_max
