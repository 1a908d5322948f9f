"""CSV tables of the ``Data/`` tree, read and written without pandas.

The reference's data pipeline (``fiude_tpu/data/builder.py``) reads every
file with ``pd.read_csv``; the card's machine has no pandas, so the port reads
and writes the same files with the ``csv`` module and numpy.  What the builder
asks of pandas is small: a date index plus named float columns
(:class:`Frame`), the undated tables (``Dates.csv``, the population table,
``Similarity_Scores.csv``) as columns of text, and two readers:

* :func:`read_frame` ``(path, index_col=0)``: the index-in-first-column files
  (``Queries/*.csv``, ``Similarity_Scores.csv`` with ``parse_dates=False``);
* :func:`read_frame` ``(path, index_col=-1)``: the date-in-last-column ILI
  files (``pd.read_csv(index_col=-1, parse_dates=True)``,
  ``builder.py:139-140``), text columns through :func:`read_columns`.

Dates are ISO ``YYYY-MM-DD``, optionally with a ``00:00:00`` time; anything
else raises, naming the file and the row.

Floats are parsed as pandas' default C parser parses them
(``precise_xstrtod``): up to 17 digits accumulated in a double, then one
multiplication or division by a power of ten.  That is not always the
correctly rounded value (it differs from ``float()`` in the last bit for
many cells of a tree written with ``repr``), and the builder's bits follow
it.  :func:`write_columns` writes floats as ``repr`` does, as
pandas' ``to_csv`` does.
"""

from __future__ import annotations

import csv
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

_MAX_DIGITS = 17                       # pandas' xstrtod accumulates at most 17 digits
_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-infinity": -math.inf}


class Frame(NamedTuple):
    """A table of float columns on an index: ``values[i, j]`` is column
    ``columns[j]`` at ``index[i]`` (``datetime64[D]`` dates, or text)."""
    index: np.ndarray
    columns: Tuple[str, ...]
    values: np.ndarray

    def column(self, name: str) -> np.ndarray:
        return self.values[:, self.columns.index(name)]

    def select(self, names: Sequence[str]) -> "Frame":
        """The columns ``names``, in that order (a missing one raises KeyError)."""
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise KeyError(f"no columns {missing}")
        cols = [self.columns.index(n) for n in names]
        return Frame(self.index, tuple(names), self.values[:, cols])

    def rows(self, rows) -> "Frame":
        """The rows at ``rows`` (positions or a boolean mask)."""
        return Frame(self.index[rows], self.columns, self.values[rows])


def read_columns(path: str) -> Tuple[List[str], List[List[str]]]:
    """``(header, columns)``: the header row and each column's cells as text."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: empty file")
    header, body = rows[0], rows[1:]
    for i, row in enumerate(body):
        if len(row) != len(header):
            raise ValueError(f"{path}, row {i + 2}: {len(row)} cells under a header of "
                             f"{len(header)}")
    return header, [list(c) for c in zip(*body)] if body else [[] for _ in header]


def _date_error(cells: Sequence[str], where: str) -> ValueError:
    for i, cell in enumerate(cells):
        day, time = cell[:10], cell[10:]
        try:
            if not (len(day) == 10 and day[4] == day[7] == "-"
                    and (day[:4] + day[5:7] + day[8:]).isdigit()
                    and time in ("", " 00:00:00", "T00:00:00")):
                raise ValueError
            np.datetime64(day, "D")
        except ValueError:
            return ValueError(f"{where}, row {i + 2}: {cell!r} is not an ISO date (YYYY-MM-DD)")
    return ValueError(f"{where}: unreadable dates")


def dates_of(cells: Sequence[str], where: str) -> np.ndarray:
    """ISO dates (``YYYY-MM-DD``, optionally ``YYYY-MM-DD 00:00:00``) as
    ``datetime64[D]``; ``where`` names the file in the error of a cell that
    is anything else."""
    if len(cells) == 0:
        return np.empty(0, "datetime64[D]")
    try:
        raw = np.array(cells, dtype="S")
    except UnicodeEncodeError:
        raise _date_error(cells, where) from None
    width = raw.dtype.itemsize
    u = raw.view(np.uint8).reshape(len(cells), width)
    ok = width in (10, 19)
    if ok:
        digit = (u[:, :10] >= ord("0")) & (u[:, :10] <= ord("9"))
        ok = bool(digit[:, [0, 1, 2, 3, 5, 6, 8, 9]].all() and (u[:, 4] == ord("-")).all()
                  and (u[:, 7] == ord("-")).all())
    if ok and width == 19:
        tail = u[:, 10:]
        time = np.frombuffer(b" 00:00:00", np.uint8)
        ok = bool(((tail == 0).all(axis=1) | (tail[:, 1:] == time[1:]).all(axis=1)
                   & np.isin(tail[:, 0], (ord(" "), ord("T")))).all())
    if not ok:
        raise _date_error(cells, where)
    try:
        return raw.astype("S10").astype("U10").astype("datetime64[D]")
    except ValueError:
        raise _date_error(cells, where) from None


def _xstrtod(text: str) -> float:
    """One cell as pandas' ``precise_xstrtod`` reads it (the vectorized
    :func:`floats_of` takes this path for exponents, NaN and infinity)."""
    if text in _NA:
        return math.nan
    if text.lower() in _INF:
        return _INF[text.lower()]
    p, n = 0, len(text)
    negative = p < n and text[p] == "-"
    if p < n and text[p] in "+-":
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and text[p].isdigit():
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(text[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and text[p] == ".":
        p += 1
        while digits < _MAX_DIGITS and p < n and text[p].isdigit():
            number = number * 10.0 + (ord(text[p]) - 48)
            p, digits, decimals = p + 1, digits + 1, decimals + 1
        while p < n and text[p].isdigit():
            p += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError
    if negative:
        number = -number
    if p < n and text[p] in "eE":
        p += 1
        negative_exp = p < n and text[p] == "-"
        if p < n and text[p] in "+-":
            p += 1
        start, e = p, 0
        while p < n and p - start < _MAX_DIGITS and text[p].isdigit():
            e = e * 10 + ord(text[p]) - 48
            p += 1
        if p == start:
            raise ValueError
        exponent += -e if negative_exp else e
    if p != n or exponent > 308:
        raise ValueError
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def floats_of(cells: Sequence[str], where: str) -> np.ndarray:
    """Cells as float64, bit for bit as pandas' default parser reads them;
    empty and NA cells are NaN.  ``where`` names the file and column in the
    error of a cell that is not a number."""
    n = len(cells)
    out = np.full(n, np.nan)
    try:
        raw = np.array(cells, dtype="S") if n else None
    except UnicodeEncodeError:
        raw = None
    rest = range(n)
    if raw is not None and raw.dtype.itemsize > 0:
        # the plain decimal cells, [sign] digits [. digits], vectorized; the
        # others (exponents, NaN, infinity, errors) one at a time below
        u = raw.view(np.uint8).reshape(n, raw.dtype.itemsize)
        signed = (u[:, 0] == ord("-")) | (u[:, 0] == ord("+"))
        v = u.copy()
        v[signed, :-1], v[signed, -1] = u[signed, 1:], 0
        is_digit = (v >= ord("0")) & (v <= ord("9"))
        is_dot = v == ord(".")
        plain = ((is_digit | is_dot | (v == 0)).all(axis=1) & (is_dot.sum(axis=1) <= 1)
                 & is_digit.any(axis=1))
        rank = np.cumsum(is_digit, axis=1)
        used = is_digit & (rank <= _MAX_DIGITS) & plain[:, None]
        dot = np.where(is_dot.any(axis=1), is_dot.argmax(axis=1), v.shape[1])
        in_int = np.arange(v.shape[1])[None, :] < dot[:, None]
        exponent = (np.maximum((is_digit & in_int).sum(axis=1) - _MAX_DIGITS, 0)
                    - (used & ~in_int).sum(axis=1))
        n_used = used.sum(axis=1)
        digits = np.zeros((n, _MAX_DIGITS))
        r, c = np.nonzero(used)
        digits[r, _MAX_DIGITS - n_used[r] + rank[r, c] - 1] = v[r, c] - ord("0")
        number = np.zeros(n)
        for k in range(_MAX_DIGITS):   # right-aligned: leading zeros add exact zeros
            number = number * 10.0 + digits[:, k]
        number = np.where(u[:, 0] == ord("-"), -number, number)
        plain &= exponent <= 308
        up, down = plain & (exponent > 0), plain & (exponent <= 0)
        out[up] = number[up] * _POW10[exponent[up]]
        out[down] = number[down] / _POW10[-exponent[down]]
        rest = np.nonzero(~plain)[0]
    for i in rest:
        try:
            out[i] = _xstrtod(cells[i])
        except ValueError:
            raise ValueError(f"{where}, row {i + 2}: {cells[i]!r} is not a number") from None
    return out


def read_frame(path: str, index_col: int = 0, parse_dates: bool = True) -> Frame:
    """Every column but the index as floats, on the index column (dates
    when ``parse_dates``, else text): ``pd.read_csv(path,
    index_col=index_col, parse_dates=parse_dates)`` for the tables of
    float columns."""
    header, columns = read_columns(path)
    ic = index_col % len(header)
    index = dates_of(columns[ic], path) if parse_dates else np.array(columns[ic], dtype=object)
    names = tuple(h for j, h in enumerate(header) if j != ic)
    values = np.empty((len(index), len(names)))
    for k, j in enumerate(j for j in range(len(header)) if j != ic):
        values[:, k] = floats_of(columns[j], f"{path}, column {header[j]!r}")
    return Frame(index, names, values)


def _cells(column) -> List[str]:
    a = np.asarray(column)
    if a.dtype.kind == "f":
        return ["" if math.isnan(v) else repr(v) for v in a.tolist()]
    if a.dtype.kind == "M":
        return [str(d) for d in a.astype("datetime64[D]")]
    return [str(v) for v in a.tolist()]


def write_columns(path: str, header: Sequence[str], columns: Sequence) -> None:
    """Write ``columns`` (sequences of equal length) under ``header``: floats
    as ``repr`` writes them (NaN as an empty cell), dates as ``YYYY-MM-DD``,
    anything else as ``str``; the ``csv`` module's quoting, ``\\n`` line ends
    (what ``DataFrame.to_csv`` writes)."""
    cols = [_cells(c) for c in columns]
    if len({len(c) for c in cols}) > 1:
        raise ValueError(f"{path}: columns of different lengths")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(zip(*cols))
