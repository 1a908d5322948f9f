"""Validate a ``Data/`` tree against the schemas the pipeline reads, with
actionable errors (counterpart of ``scripts/validate_data_tree.py``).

The reference keeps its ``Data/`` directory out of its repository, so the
loader contract (reference ``lib/regional_data_builder.py:21-147``; the
port's :mod:`fiude_tpu_torch.data.builder`) exists only in code.  This command
checks a tree before a long sweep reads it: file set, columns, index types,
dates, region completeness, and the cross-file joins (query columns against
``Similarity_Scores.csv``, ``Dates.csv`` splits against the ILI span) that
otherwise fail deep inside the builder.  It reads the files with
:mod:`fiude_tpu_torch.data.tables` (no pandas), and its dates are the port's
builder's: ISO ``YYYY-MM-DD``, strictly.

The checks are the JAX script's, in its order and under its names:
``Dates.csv``, ``national_flu.csv``, ``hhs_flu.csv``, ``population``,
``state_flu.csv``, ``queries+similarity``, ``season spans`` and, with
``--deep``, ``deep (DataConstructor)``, each giving one ``(name, ok,
message)`` row when it passes and one a problem when it does not, as there
(a check that crashes gives one row).

    python -m fiude_tpu_torch.scripts.validate_data_tree /path/to/Data \\
        [--regions US hhs state] [--seasons 2016 2017] [--deep]

``--deep`` also runs the port's :class:`~fiude_tpu_torch.data.builder.
DataConstructor` end to end per (region, season) and prints the shapes (on
the host: the builder is numpy).

Exit status: 0 only if every check passes.
"""

from __future__ import annotations

import argparse
import datetime as dt
import os
import re
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from fiude_tpu_torch.data.regions import HHS_REGION_STATES, STATE_CODES, STATE_NAMES
from fiude_tpu_torch.data.tables import dates_of, floats_of, read_columns

IGNORE = ("VI", "PR")  # territories the HHS weighting skips (builder.py:182)
_ILI_FILES = {"US": "national_flu.csv", "hhs": "hhs_flu.csv", "state": "state_flu.csv"}
_INT = re.compile(r"^\s*[+-]?\d+\s*$")

Check = Tuple[str, bool, str]  # (name, ok, message)


class _Table:
    """A CSV as text columns around its index column (``index_col``)."""

    def __init__(self, header: List[str], columns: List[List[str]], index_col: int):
        ic = index_col % len(header)
        self.index = columns[ic]
        self.names = [h for j, h in enumerate(header) if j != ic]
        self.cols = {h: c for j, (h, c) in enumerate(zip(header, columns)) if j != ic}


def _read_csv(root: str, rel: str, errors: List[str], index_col: int = 0) -> Optional[_Table]:
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        errors.append(f"{rel}: MISSING (expected at {path})")
        return None
    try:
        header, columns = read_columns(path)
        return _Table(header, columns, index_col)
    except Exception as e:
        errors.append(f"{rel}: unreadable as CSV ({type(e).__name__}: {e})")
        return None


def _numeric(cells: Sequence[str]) -> bool:
    try:
        floats_of(cells, "")
        return True
    except ValueError:
        return False


def _dates(cells: Sequence[str]) -> Optional[np.ndarray]:
    try:
        return dates_of(cells, "")
    except ValueError:
        return None


def _seasons(table: _Table, seasons) -> List[int]:
    """The rows ``seasons`` names (``.loc[seasons]``: an absent one raises),
    or every row."""
    if not seasons:
        return list(range(len(table.index)))
    labels = [int(s) if _INT.match(s) else s for s in table.index]
    absent = [s for s in seasons if s not in labels]
    if absent:
        raise KeyError(f"Dates.csv: requested seasons {absent} not in index {labels}")
    return [i for s in seasons for i, lab in enumerate(labels) if lab == s]


def check_dates(root: str, seasons=None) -> List[str]:
    """``Dates.csv``: season-indexed train/test split dates (reference
    :253-267 reads ``.loc[test_season]`` and strptime ``%Y-%m-%d`` on four
    columns)."""
    errors: List[str] = []
    df = _read_csv(root, "Dates.csv", errors)
    if df is None:
        return errors
    required = ["train_start", "train_end", "test_start", "test_end"]
    missing = [c for c in required if c not in df.cols]
    if missing:
        errors.append(f"Dates.csv: missing columns {missing} (has {df.names})")
        return errors
    if not all(_INT.match(s) for s in df.index):
        errors.append("Dates.csv: index (season) must be integral years")
    for i in _seasons(df, seasons):
        season = df.index[i]
        parsed = {}
        for col in required:
            cell = df.cols[col][i]
            try:
                parsed[col] = dt.datetime.strptime(cell or "nan", "%Y-%m-%d")
            except ValueError as e:
                errors.append(f"Dates.csv season {season}: {col}={cell!r} does not parse as "
                              f"%Y-%m-%d ({e})")
        if len(parsed) == len(required):
            if not (parsed["train_start"] < parsed["train_end"]
                    <= parsed["test_start"] < parsed["test_end"]):
                errors.append(
                    f"Dates.csv season {season}: dates must be ordered train_start < "
                    "train_end <= test_start < test_end, got "
                    + ", ".join(f"{c}={df.cols[c][i]}" for c in required))
    return errors


def _check_weekly_index(rel: str, dates: Optional[np.ndarray], errors: List[str]):
    if dates is None:
        errors.append(f"{rel}: date index did not parse as ISO dates (YYYY-MM-DD) in the last "
                      "column")
        return
    gaps = np.diff(dates).astype(int)
    if len(gaps) and (gaps < 0).any():
        errors.append(f"{rel}: date index is not sorted ascending")
    if len(gaps) and not np.all(gaps == 7):
        bad = int(np.sum(gaps != 7))
        errors.append(f"{rel}: expected weekly (7-day) spacing; {bad} of {len(gaps)} gaps "
                      f"differ (first bad gap {gaps[gaps != 7][0]}d): the cubic weekly->daily "
                      "interpolation assumes an even weekly grid")


def check_national_flu(root: str) -> List[str]:
    """``national_flu.csv``: weekly US ILI with ``weighted_ili`` (reference
    :128, :147-148 reads it with the date in the last column)."""
    errors: List[str] = []
    df = _read_csv(root, "national_flu.csv", errors, index_col=-1)
    if df is None:
        return errors
    if "weighted_ili" not in df.cols:
        errors.append(f"national_flu.csv: missing 'weighted_ili' column (has {df.names})")
        return errors
    if not _numeric(df.cols["weighted_ili"]):
        errors.append("national_flu.csv: 'weighted_ili' is not numeric")
    _check_weekly_index("national_flu.csv", _dates(df.index), errors)
    return errors


def check_long_flu(root: str, region: str) -> List[str]:
    """``hhs_flu.csv`` / ``state_flu.csv``: long format (region,
    unweighted_ili, the date in the last column); reference :129-135 pivots
    on ``region`` and reads ``unweighted_ili``."""
    rel = f"{region}_flu.csv"
    errors: List[str] = []
    df = _read_csv(root, rel, errors, index_col=-1)
    if df is None:
        return errors
    for col in ("region", "unweighted_ili"):
        if col not in df.cols:
            errors.append(f"{rel}: missing '{col}' column (has {df.names})")
    if errors:
        return errors
    if not _numeric(df.cols["unweighted_ili"]):
        errors.append(f"{rel}: 'unweighted_ili' is not numeric")
    regions = np.asarray(df.cols["region"], dtype=object)
    have = set(regions.tolist())
    want = ({f"Region {i}" for i in range(1, 11)} if region == "hhs" else set(STATE_NAMES))
    missing = sorted(want - have)
    if missing:
        errors.append(f"{rel}: missing region series {missing[:5]}"
                      f"{' ...' if len(missing) > 5 else ''} ({len(missing)} of {len(want)})")
    index = np.asarray(df.index, dtype=object)
    for r in sorted(have & want)[:3]:  # spot-check weekly spacing
        _check_weekly_index(f"{rel}[{r}]", _dates(index[regions == r].tolist()), errors)
    return errors


def check_population(root: str, needed_codes) -> List[str]:
    """``state_population_data_2019.csv``: CODE/POP (reference :34,49-53)."""
    errors: List[str] = []
    df = _read_csv(root, "state_population_data_2019.csv", errors)
    if df is None:
        return errors
    for col in ("CODE", "POP"):
        if col not in df.cols:
            errors.append(f"state_population_data_2019.csv: missing '{col}' column "
                          f"(has {df.names})")
    if errors:
        return errors
    if not _numeric(df.cols["POP"]):
        errors.append("state_population_data_2019.csv: 'POP' is not numeric")
    elif (floats_of(df.cols["POP"], "POP") <= 0).any():
        errors.append("state_population_data_2019.csv: non-positive POP values: population "
                      "weights would divide by zero")
    missing = sorted(set(needed_codes) - set(df.cols["CODE"]))
    if missing:
        errors.append(f"state_population_data_2019.csv: missing CODE rows for {missing}: HHS "
                      "population weighting needs every member state")
    return errors


def _check_query_file(root: str, rel: str, errors: List[str]) -> Optional[_Table]:
    df = _read_csv(root, rel, errors)
    if df is None:
        return None
    if _dates(df.index) is None:
        errors.append(f"{rel}: index did not parse as ISO dates (YYYY-MM-DD)")
        return df
    if not df.names:
        errors.append(f"{rel}: no query columns")
    non_num = [c for c in df.names if not _numeric(df.cols[c])]
    if non_num:
        errors.append(f"{rel}: non-numeric query columns {non_num[:5]}")
    if len(df.index) < 8:
        errors.append(f"{rel}: only {len(df.index)} rows: the 7-day smoother "
                      "(builder.smooth) consumes the first 7")
    return df


def check_queries(root: str, regions) -> List[str]:
    """Query CSVs and the ``Similarity_Scores.csv`` join (reference
    :33-75,83-120): every member state's file must exist, have a date index,
    and share column names with the similarity table."""
    errors: List[str] = []
    scores = _read_csv(root, "Similarity_Scores.csv", errors)

    all_query_cols: set = set()
    if "US" in regions:
        df = _check_query_file(root, os.path.join("Queries", "US_query_data_all_smoothed.csv"),
                               errors)
        if df is not None:
            all_query_cols |= set(df.names)
    state_codes_needed = set()
    if "hhs" in regions:
        for codes in HHS_REGION_STATES.values():
            state_codes_needed |= {c for c in codes if c not in IGNORE}
    if "state" in regions:
        state_codes_needed |= set(STATE_CODES)
    per_region_cols = {}
    for code in sorted(state_codes_needed):
        df = _check_query_file(
            root, os.path.join("Queries", "state_queries", f"{code}_query_data.csv"), errors)
        if df is not None:
            per_region_cols[code] = set(df.names)
            all_query_cols |= set(df.names)

    # HHS aggregation intersects member columns (builder.py:75-81)
    if "hhs" in regions and per_region_cols:
        for num, codes in HHS_REGION_STATES.items():
            cols = [per_region_cols[c] for c in codes if c in per_region_cols]
            if cols and not set.intersection(*cols):
                errors.append(f"Queries: HHS Region {num} member states share NO common query "
                              "columns: the population-weighted aggregate would be empty")

    if scores is not None and all_query_cols:
        if not all_query_cols & set(scores.index):
            errors.append(
                "Similarity_Scores.csv: its index shares no names with any query column: "
                f"choose_qs would drop every query (scores index head: {scores.index[:3]}, "
                f"query cols head: {sorted(all_query_cols)[:3]})")
        num_cols = [c for c in scores.names if not _numeric(scores.cols[c])]
        if num_cols:
            errors.append(f"Similarity_Scores.csv: non-numeric score columns {num_cols}")
    return errors


def check_span(root: str, regions, seasons=None) -> List[str]:
    """Cross-file: every requested season's split dates must fall inside the
    ILI span (otherwise the split lookup finds no window, reference
    :253-267)."""
    errors: List[str] = []
    try:
        header, columns = read_columns(os.path.join(root, "Dates.csv"))
        dates = _Table(header, columns, 0)
    except Exception:
        return []  # already reported by check_dates
    spans = {}
    for region in regions:
        try:
            header, columns = read_columns(os.path.join(root, _ILI_FILES[region]))
        except Exception:
            continue
        days = _dates(columns[-1])
        # an index that is not dates cannot be compared with one (pandas: TypeError)
        spans[region] = None if days is None else (days.min(), days.max())
    for i in _seasons(dates, seasons):
        try:
            lo = np.datetime64(dt.datetime.strptime(dates.cols["train_start"][i], "%Y-%m-%d"), "D")
            hi = np.datetime64(dt.datetime.strptime(dates.cols["test_end"][i], "%Y-%m-%d"), "D")
        except Exception:
            continue  # already reported by check_dates
        for region, span in spans.items():
            if span is None:
                raise TypeError(f"{_ILI_FILES[region]}: the index is not dates")
            smin, smax = span
            if lo < smin or hi > smax:
                errors.append(
                    f"Dates.csv season {dates.index[i]} [{dates.cols['train_start'][i]} ... "
                    f"{dates.cols['test_end'][i]}] falls outside the {region} ILI span [{smin} "
                    f"... {smax}]: the split lookup would find no window")
    return errors


def check_deep(root: str, regions, seasons) -> List[str]:
    """End to end: the port's DataConstructor on a small window."""
    from fiude_tpu_torch.data.builder import DataConstructor
    errors: List[str] = []
    for region in regions:
        for season in seasons:
            try:
                dc = DataConstructor(test_season=season, region=region, n_queries=3, gamma=14,
                                     window_size=7,
                                     root=root if root.endswith(os.sep) else root + os.sep)
                x_tr, _, x_te, _, _ = dc(run_backward=True, no_qs_in_output=True)
                if 0 in (*x_tr.shape, *x_te.shape):
                    errors.append(f"deep {region}/{season}: empty split (x_train {x_tr.shape}, "
                                  f"x_test {x_te.shape})")
                else:
                    print(f"  deep {region}/{season}: x_train {x_tr.shape} x_test {x_te.shape} "
                          "OK")
            except Exception as e:
                errors.append(f"deep {region}/{season}: DataConstructor raised "
                              f"{type(e).__name__}: {e}")
    return errors


def validate_tree(root: str, regions=("US", "hhs", "state"), seasons=None,
                  deep: bool = False) -> List[Check]:
    """Run every applicable check; returns (name, ok, message) rows."""
    regions = list(regions)
    needed_codes = set()
    if "hhs" in regions:
        for codes in HHS_REGION_STATES.values():
            needed_codes |= {c for c in codes if c not in IGNORE}
    checks: List[Tuple[str, Callable[[], List[str]]]] = [
        ("Dates.csv", lambda: check_dates(root, seasons)),
    ]
    if "US" in regions:
        checks.append(("national_flu.csv", lambda: check_national_flu(root)))
    if "hhs" in regions:
        checks.append(("hhs_flu.csv", lambda: check_long_flu(root, "hhs")))
        checks.append(("population", lambda: check_population(root, needed_codes)))
    if "state" in regions:
        checks.append(("state_flu.csv", lambda: check_long_flu(root, "state")))
    checks.append(("queries+similarity", lambda: check_queries(root, regions)))
    checks.append(("season spans", lambda: check_span(root, regions, seasons)))
    if deep:
        deep_seasons = seasons
        if not deep_seasons:
            try:
                deep_seasons = [int(read_columns(os.path.join(root, "Dates.csv"))[1][0][0])]
            except Exception:
                deep_seasons = []
        checks.append(("deep (DataConstructor)",
                       lambda: check_deep(root, regions, deep_seasons or [])))

    results: List[Check] = []
    for name, fn in checks:
        try:
            errs = fn()
        except Exception as e:  # a check itself must never crash the command
            errs = [f"{name}: check crashed: {type(e).__name__}: {e}"]
        if errs:
            results.extend((name, False, e) for e in errs)
        else:
            results.append((name, True, "OK"))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", help="path to the Data/ directory")
    ap.add_argument("--regions", nargs="+", default=["US", "hhs", "state"],
                    choices=["US", "hhs", "state"])
    ap.add_argument("--seasons", nargs="+", type=int, default=None,
                    help="restrict Dates.csv/span checks to these seasons")
    ap.add_argument("--deep", action="store_true",
                    help="also run DataConstructor end to end per (region, season)")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.root):
        print(f"FAIL: {args.root} is not a directory")
        return 1
    results = validate_tree(args.root, regions=args.regions, seasons=args.seasons,
                            deep=args.deep)
    n_fail = 0
    for name, ok, msg in results:
        if ok:
            print(f"  OK  {name}")
        else:
            n_fail += 1
            print(f"FAIL  {name}: {msg}")
    print(f"{len(results) - n_fail}/{len(results)} checks passed"
          + (f", {n_fail} FAILED" if n_fail else ""))
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
