"""Summarize a results table into the reference's headline comparison: mean
test NLL and skill per region x model, averaged over seasons, horizons and
replicates (counterpart of ``scripts/summarize_results.py:23-37``, read
through :func:`fiude_tpu_torch.utils.results.read_table`, no pandas).

    python -m fiude_tpu_torch.scripts.summarize_results results_table_server.csv

The JAX script's ``--markdown`` and ``--ordering`` modes and its row filters
are not ported: no part of the sweep command uses them.
"""

from __future__ import annotations

import argparse
import math
import re
from typing import Any, Dict, List, Sequence

import numpy as np

from fiude_tpu_torch.utils.results import read_table

NLL_COL = re.compile(r"^(\d{4}) (\d+)$")
SKILL_COL = re.compile(r"^skill (\d{4}) (\d+)$")
FIELDS = ("region", "model", "runs", "mean_nll", "mean_skill")


def _nanmean(rows: Sequence[Dict[str, Any]], cols: Sequence[str]) -> float:
    """``np.nanmean`` of the rows' ``cols`` cells (missing ones NaN), over the
    column-major array pandas' ``to_numpy`` gives, so the sum runs in its
    order."""
    vals = np.asfortranarray([[float(row.get(c, math.nan)) for c in cols] for row in rows])
    with np.errstate(invalid="ignore"):
        return float(np.nanmean(vals)) if vals.size and not np.isnan(vals).all() else math.nan


def summarize(columns: Sequence[str], rows: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One row a (region, ode_name) group, in ``FIELDS``: its runs and the
    ``nanmean`` over its ``"YYYY N"`` and its ``"skill YYYY N"`` cells; groups
    in key order, then sorted stably by region and mean NLL, NaN last
    (``columns``, ``rows``: what :func:`read_table` gives)."""
    nll_cols = [c for c in columns if NLL_COL.match(str(c))]
    skill_cols = [c for c in columns if SKILL_COL.match(str(c))]
    groups: Dict[tuple, list] = {}
    for row in rows:
        if row.get("region") is not None and row.get("ode_name") is not None:
            groups.setdefault((row["region"], row["ode_name"]), []).append(row)
    out = [{"region": region, "model": model, "runs": len(g),
            "mean_nll": _nanmean(g, nll_cols),
            "mean_skill": _nanmean(g, skill_cols) if skill_cols else math.nan}
           for (region, model), g in sorted(groups.items())]
    return sorted(out, key=lambda r: (r["region"], math.isnan(r["mean_nll"]),
                                      0.0 if math.isnan(r["mean_nll"]) else r["mean_nll"]))


def format_summary(summary: Sequence[Dict[str, Any]]) -> str:
    """The summary as a right-aligned text table, a header and a line a row."""
    cells = [list(FIELDS)] + [[f"{r[k]:.6f}" if isinstance(r[k], float) else str(r[k])
                               for k in FIELDS] for r in summary]
    widths = [max(len(row[j]) for row in cells) for j in range(len(FIELDS))]
    return "\n".join(" ".join(c.rjust(w) for c, w in zip(row, widths)) for row in cells)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("csv")
    args = ap.parse_args(argv)
    columns, _, rows = read_table(args.csv)
    print(format_summary(summarize(columns, rows)))


if __name__ == "__main__":
    main()
