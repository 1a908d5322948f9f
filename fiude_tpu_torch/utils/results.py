"""Results-table writer and the model evaluation entry point.

Counterpart of ``fiude_tpu/utils/results.py:22-99`` (reference
``lib/utils.py:20-56``): run the model at test time with 128 MC samples,
un-scale, compute NLL and CDC skill at the 1-4 week horizons, and upsert a
row (matched on the config variables) into ``{file_name}.csv`` under a file
lock.  Column naming preserved: ``"{season} {day_index}"`` for NLL and
``"skill {season} {weeks}"``.

The sweeps' tables are shared with the JAX package, which reads and writes
them with pandas under a ``filelock`` lock.  The port uses neither: the table
is read and written with the ``csv`` module in the layout pandas gives it
(an unnamed index column first, an empty cell for a missing value), the lock
is ``fcntl.flock`` on the same ``{file_name}.lock`` (what ``filelock`` takes on
POSIX, so writers of both packages exclude each other), and the write goes to
a same-directory temp file, then ``os.replace``: a writer killed mid-write
leaves the old table.
"""

from __future__ import annotations

import contextlib
import csv
import fcntl
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from fiude_tpu_torch.utils import metrics as Metrics


@contextlib.contextmanager
def file_lock(lock_path: str):
    """Hold an exclusive ``flock`` on ``lock_path`` (created if missing)."""
    fd = os.open(lock_path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _parse(cell: str):
    """A CSV cell as pandas would type it: empty -> None (NaN), else int,
    float or the string itself."""
    if cell == "":
        return None
    for kind in (int, float):
        try:
            return kind(cell)
        except ValueError:
            pass
    return cell


def _format(value) -> str:
    if value is None or (isinstance(value, (float, np.floating)) and np.isnan(value)):
        return ""
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


def read_table(csv_path: str) -> Tuple[List[str], List[int], List[Dict[str, Any]]]:
    """``(columns, index, rows)`` of a results table: what
    ``pd.read_csv(csv_path, index_col=0)`` holds, each row a dict of its
    non-missing cells."""
    with open(csv_path, newline="") as fh:
        lines = list(csv.reader(fh))
    if not lines:
        return [], [], []
    columns = lines[0][1:]
    index, rows = [], []
    for line in lines[1:]:
        if not line:
            continue
        index.append(int(line[0]))
        cells = {c: _parse(v) for c, v in zip(columns, line[1:])}
        rows.append({c: v for c, v in cells.items() if v is not None})
    return columns, index, rows


def atomic_write_table(csv_path: str, columns: List[str], index: List[int],
                       rows: List[Dict[str, Any]]) -> None:
    """Write the table to ``csv_path`` through a same-directory temp file and
    ``os.replace``, so a kill or a timeout mid-write can never leave a
    truncated table behind: readers see the old file or the new one."""
    tmp_path = csv_path + f".tmp.{os.getpid()}"
    with open(tmp_path, "w", newline="") as fh:
        out = csv.writer(fh, lineterminator="\n")
        out.writerow([""] + columns)
        for i, row in zip(index, rows):
            out.writerow([str(i)] + [_format(row.get(c)) for c in columns])
    os.replace(tmp_path, csv_path)


def evaluate_forecast(y_pred: np.ndarray, y_test: np.ndarray, scaler: np.ndarray, *,
                      window_size: int, test_season: int) -> Dict[str, float]:
    """Horizon metrics from an MC forecast ensemble.

    y_pred: (B, S, T, R); y_test: (B, T, R); scaler: (R,).
    Returns {"{season} {g}": nll, "skill {season} {w}": skill} for the four
    weekly horizons (lib/utils.py:52-54).
    """
    scaler = np.asarray(scaler).reshape(1, 1, 1, -1)
    y_pr = np.asarray(y_pred) * scaler
    y_te = np.asarray(y_test) * scaler[0]
    pred_mean = y_pr.mean(1)
    pred_std = y_pr.std(1)

    out = {}
    for col, g in zip([7, 14, 21, 28],
                      [window_size + 6, window_size + 13,
                       window_size + 20, window_size + 27]):
        out[f"{test_season} {g}"] = Metrics.nll(
            y_te[:, g, :], pred_mean[:, g, :], pred_std[:, g, :])
        out[f"skill {test_season} {col}"] = Metrics.skill(
            y_te[:, g, :], pred_mean[:, g, :], pred_std[:, g, :])
    return out


def upsert_results_row(file_name: str, variables: Dict, values: Dict) -> None:
    """File-locked upsert into ``{file_name}.csv`` matched on ``variables``
    (lib/utils.py:28-56): the first row whose every variable equals the given
    one is updated, else a row is added under the next index.  Creates the
    table if missing."""
    csv_path = file_name + ".csv"
    with file_lock(file_name + ".lock"):
        columns, index, rows = read_table(csv_path) if os.path.exists(csv_path) else ([], [], [])
        match = None
        if all(key in columns for key in variables):
            for n, row in enumerate(rows):
                if all(key in row and row[key] == value for key, value in variables.items()):
                    match = n
                    break
        if match is None:
            index.append(max(index) + 1 if index else 0)
            rows.append({})
            match = len(rows) - 1
        for key, value in {**variables, **values}.items():
            if key not in columns:
                columns.append(key)
            rows[match][key] = value
        atomic_write_table(csv_path, columns, index, rows)


def test_and_record(trainer, scaler, x_test, y_test, t, *, test_season: int,
                    window_size: int = 1, variables: Optional[Dict] = None,
                    n_samples: int = 128, file_name: str = "results_table"):
    """Reference ``utils.test``: forecast at 128 samples, metrics, upsert."""
    variables = variables or {"ode_name": "CONN"}
    y_pred = trainer.forecast(x_test, t, n_samples=n_samples).cpu().numpy()
    values = evaluate_forecast(y_pred, np.asarray(y_test), np.asarray(scaler),
                               window_size=window_size, test_season=test_season)
    upsert_results_row(file_name, variables, values)
    return values


test_and_record.__test__ = False     # a library function, not a pytest test
