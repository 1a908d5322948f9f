"""The port's ``Data/``-tree validator, ``summarize`` and ``run_sweep
--summary`` against the JAX package's scripts, on the CPU:

* ``fiude_tpu_torch.scripts.validate_data_tree.validate_tree`` gives the
  ``(name, ok)`` rows of ``scripts/validate_data_tree.py::validate_tree``, in
  order, and ``main`` its exit status: on the good tree, with ``--deep`` on
  one season, on each broken tree that ``tests/test_validate_data_tree.py``
  builds, on a requested season the tree lacks and on a missing tree (the
  messages may be worded otherwise);
* ``summarize`` equals ``scripts/summarize_results.py::summarize`` on the
  cases of ``tests/test_summarize.py`` and on a random table, bit for bit;
* ``run_sweep --summary`` prints the table after the sweep, and says "no
  results" when there are none.
"""
import functools
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from fiude_tpu.data.synthetic import write_reference_data_tree
from scripts import validate_data_tree as jax_vdt
from scripts.summarize_results import summarize as jax_summarize

from fiude_tpu_torch.scripts import run_sweep, validate_data_tree
from fiude_tpu_torch.scripts.summarize_results import summarize
from fiude_tpu_torch.train import experiment
from fiude_tpu_torch.utils import config as port_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vdt") / "Data")
    write_reference_data_tree(root, n_qs=6, seed=0, n_weeks=220)
    return root


def rows(results):
    return [(name, ok) for name, ok, _ in results]


def assert_same_verdict(root, **kw):
    want = jax_vdt.validate_tree(root, **kw)
    got = validate_data_tree.validate_tree(root, **kw)
    assert rows(got) == rows(want), ([r for r in got if not r[1]], [r for r in want if not r[1]])
    return got


def exit_status(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["validate_data_tree.py", *argv])
    return main(argv) if main is validate_data_tree.main else main()


def test_good_tree_passes_as_in_jax(tree, monkeypatch, capsys):
    assert not [r for r in assert_same_verdict(tree) if not r[1]]
    assert exit_status(validate_data_tree.main, [tree], monkeypatch) == 0
    assert exit_status(jax_vdt.main, [tree], monkeypatch) == 0
    assert "7/7 checks passed" in capsys.readouterr().out


def test_deep_on_one_season_as_in_jax(tree):
    season = int(pd.read_csv(os.path.join(tree, "Dates.csv"), index_col=0).index[1])
    got = assert_same_verdict(tree, regions=["US"], seasons=[season], deep=True)
    assert rows(got)[-1] == ("deep (DataConstructor)", True)


def copy(tree, tmp_path):
    dst = str(tmp_path / "Data")
    shutil.copytree(tree, dst)
    return dst


def drop_query_file(dst):
    os.remove(os.path.join(dst, "Queries", "state_queries", "CA_query_data.csv"))


def drop_hhs_column(dst):
    p = os.path.join(dst, "hhs_flu.csv")
    pd.read_csv(p).drop(columns=["unweighted_ili"]).to_csv(p, index=False)


def set_dates_cell(column, value):
    def edit(dst):
        p = os.path.join(dst, "Dates.csv")
        df = pd.read_csv(p, index_col=0)
        df.iloc[0, df.columns.get_loc(column)] = value
        df.to_csv(p)
    return edit


def rename_scores(dst):
    p = os.path.join(dst, "Similarity_Scores.csv")
    df = pd.read_csv(p, index_col=0)
    df.index = [f"other_{i}" for i in range(len(df))]
    df.to_csv(p)


def drop_population_row(dst):
    p = os.path.join(dst, "state_population_data_2019.csv")
    df = pd.read_csv(p, index_col=0)
    df[df["CODE"] != "NY"].to_csv(p)


BROKEN = {
    "missing_query_file": (drop_query_file, ["state"]),
    "missing_hhs_column": (drop_hhs_column, ["hhs"]),
    "unparseable_split_date": (set_dates_cell("train_end", "08/01/2015"), ["US"]),
    "similarity_join_mismatch": (rename_scores, ["US"]),
    "missing_population_row": (drop_population_row, ["hhs"]),
    "season_outside_span": (set_dates_cell("test_end", "2099-05-01"), ["US"]),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_trees_fail_as_in_jax(tree, tmp_path, monkeypatch, case):
    edit, regions = BROKEN[case]
    dst = copy(tree, tmp_path)
    edit(dst)
    got = assert_same_verdict(dst, regions=regions)
    assert any(not ok for _, ok, _ in got)
    argv = [dst, "--regions", *regions]
    assert exit_status(validate_data_tree.main, argv, monkeypatch) == 1
    assert exit_status(jax_vdt.main, argv, monkeypatch) == 1


def test_absent_season_and_missing_tree_as_in_jax(tree, tmp_path, monkeypatch):
    assert_same_verdict(tree, regions=["US"], seasons=[1999])
    assert_same_verdict(str(tmp_path / "nope"))
    argv = [str(tmp_path / "nope")]
    assert exit_status(validate_data_tree.main, argv, monkeypatch) == 1
    assert exit_status(jax_vdt.main, argv, monkeypatch) == 1


# -- summarize -------------------------------------------------------------------------

def as_rows(frame):
    """A DataFrame as ``read_table`` gives it: columns, and each row's
    non-missing cells."""
    return list(frame.columns), [{k: v for k, v in r.items()
                                  if not (isinstance(v, float) and np.isnan(v))}
                                 for r in frame.to_dict("records")]


def random_table():
    rng = np.random.default_rng(0)
    records = []
    for i in range(60):
        r = {"region": str(rng.choice(["US", "hhs", "state"])),
             "ode_name": str(rng.choice(["CONN", "UONN", "SONN"])), "num": i}
        for s in (2015, 2016, 2017):
            for g in (13, 20, 27, 34):
                if rng.uniform() > 0.2:
                    r[f"{s} {g}"] = rng.lognormal()
            for w in (7, 14, 21, 28):
                if rng.uniform() > 0.2:
                    r[f"skill {s} {w}"] = rng.uniform()
        records.append(r)
    records.append({"region": "US", "ode_name": "SONNb", "num": 99})   # no NLL: NaN, last
    return pd.DataFrame(records)


SUMMARY_CASES = {
    "groups_and_averages": pd.DataFrame([
        {"region": "US", "ode_name": "CONN", "num": 1, "2015 13": 2.0, "2015 20": 4.0,
         "skill 2015 7": 0.2},
        {"region": "US", "ode_name": "CONN", "num": 2, "2015 13": 4.0, "2015 20": 6.0,
         "skill 2015 7": 0.4},
        {"region": "US", "ode_name": "UONN", "num": 1, "2015 13": 1.0, "2015 20": 1.0,
         "skill 2015 7": 0.6}]),
    "ignores_nan_cells": pd.DataFrame([
        {"region": "US", "ode_name": "CONN", "2015 13": 2.0, "2016 13": np.nan,
         "skill 2015 7": 0.5}]),
    "random": random_table(),
}


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_summarize_equals_jax(case):
    frame = SUMMARY_CASES[case]
    want = jax_summarize(frame).to_dict("records")
    got = summarize(*as_rows(frame))
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k in ("region", "model", "runs"):
            assert g[k] == w[k]
        for k in ("mean_nll", "mean_skill"):
            assert np.array_equal(g[k], w[k], equal_nan=True), (k, g, w)


@pytest.fixture
def tiny_region(monkeypatch):
    monkeypatch.setitem(port_config.REGION_INFO, "tinysum", {
        "n_regions": 1, "latent_dim": 8, "n_qs": 3,
        "ode_params": {"net_sizes": (8, 8), "aug_net_sizes": (8, 8)}, "dec_params": {},
        "enc_params": {"q_sizes": (12,), "ff_sizes": (8,)}, "epochs": 4})
    monkeypatch.setattr(experiment, "synthetic_dataset", functools.partial(
        experiment.synthetic_dataset, n_seasons=2, season_len=80))
    return ["--regions", "tinysum", "--seasons", "2016", "--epochs", "4", "--windows", "7",
            "--gammas", "28", "--nums", "1", "--models", "CONN", "--device", "cpu"]


def test_run_sweep_prints_the_summary(tiny_region, tmp_path, capsys):
    run_sweep.main(["--synthetic", *tiny_region, "--work-dir", str(tmp_path), "--out", "res",
                    "--summary"])
    lines = capsys.readouterr().out.strip().splitlines()
    head = lines.index(next(ln for ln in lines if ln.split()[:2] == ["region", "model"]))
    assert lines[head - 1] == "processed 1/1 configs"
    assert lines[head].split() == ["region", "model", "runs", "mean_nll", "mean_skill"]
    assert lines[head + 1].split()[:3] == ["tinysum", "CONN", "1"] and len(lines) == head + 2


def test_run_sweep_says_no_results(tiny_region, tmp_path, capsys):
    run_sweep.main([*tiny_region, "--data-root", str(tmp_path / "no_tree"),
                    "--work-dir", str(tmp_path), "--out", "res", "--summary"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2:] == ["processed 0/1 configs",
                        f"--summary: no results at {tmp_path / 'res'}.csv"]
