"""The port's regional data pipeline (``fiude_tpu_torch.data``: ``tables``,
``regions``, ``builder``, the tree writer, ``return_folds`` and
``convert_to_arrays``) against the JAX package's, on the CPU, without the
reference's files: the JAX package's ``write_reference_data_tree`` writes a
``Data/`` tree (300 weeks, 6 queries, as ``tests/test_data.py``) and both
pipelines read it.

* the CSV reader gives pandas' ``read_csv`` values bit for bit (pandas' own
  float parser, not ``float()``) and refuses dates that are not ISO;
* the port's writer writes the JAX writer's files byte for byte, and the JAX
  ``DataConstructor`` reads it to the same arrays;
* ``smooth``, ``load_ili``, ``interpolate_ili`` (both modes),
  ``get_hhs_query_data`` and ``choose_qs`` (names and order) equal their JAX
  counterparts bit for bit;
* ``DataConstructor`` equals the JAX one bit for bit (all four arrays and
  the scaler): ``US`` and ``hhs`` over ``run_backward`` x ``no_qs_in_output``
  x ``fill_1``, ``state`` at ``run_backward=True, no_qs_in_output=True`` with
  ``fill_1`` both ways.  The JAX constructor is slow (its windows are a Python
  loop over pandas slices, ~20 s for ``state``), so its results are built
  once a module, in three processes started with the module's first test.
"""
import filecmp
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from fiude_tpu.data import builder as jax_builder
from fiude_tpu.data import loader as jax_loader
from fiude_tpu.data import regions as jax_regions
from fiude_tpu.data import synthetic as jax_synthetic

from fiude_tpu_torch.data import builder, loader, regions, synthetic, tables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEASON, N_QUERIES = 2014, 4
COMBOS = [(rb, nq, f1) for rb in (False, True) for nq in (False, True) for f1 in (False, True)]
# (tree, region, run_backward, no_qs_in_output, fill_1): the JAX constructor's runs, in
# three groups of ~35 s each
JOBS = [[("jax", "state", True, True, False)] + [("jax", "US") + c for c in COMBOS]
        + [("port", "US", True, True, False)],
        [("jax", "state", True, True, True)] + [("jax", "hhs") + c for c in COMBOS[:2]],
        [("jax", "hhs") + c for c in COMBOS[2:]]]

_WORKER = """
import sys
import numpy as np
from fiude_tpu.data.builder import DataConstructor
out, season, n_queries = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
for job in sys.argv[4:]:
    root, region, rb, nq, f1 = job.split(",")
    arrays = DataConstructor(season, region, n_queries=n_queries, root=root,
                             fill_1=f1 == "1")(run_backward=rb == "1", no_qs_in_output=nq == "1")
    name = "_".join(job.split(",")[1:]) + ("_port" if root.endswith("port") else "")
    np.savez(f"{out}/{name}.npz", *arrays[:4], scaler=arrays[4].values)
"""


def job_name(tree, region, rb, nq, f1):
    return f"{region}_{int(rb)}_{int(nq)}_{int(f1)}" + ("_port" if tree == "port" else "")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    jax_synthetic.write_reference_data_tree(str(base / "jax"), n_qs=6, seed=0, n_weeks=300)
    synthetic.write_reference_data_tree(str(base / "port"), n_qs=6, seed=0, n_weeks=300)
    return {"jax": str(base / "jax"), "port": str(base / "port"), "base": base}


@pytest.fixture(scope="module", autouse=True)
def jax_runs(trees):
    """The JAX ``DataConstructor``'s outputs by job name, built in three
    processes from the module's start; the first read waits for them."""
    out = trees["base"] / "jax_runs"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(out), str(SEASON), str(N_QUERIES)]
        + [",".join([trees[j[0]], j[1]] + [str(int(v)) for v in j[2:]]) for j in group],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for group in JOBS]

    def read(name):
        for p in procs:
            if p.returncode is None:
                _, err = p.communicate(timeout=600)
                assert p.returncode == 0, err
        with np.load(out / f"{name}.npz") as z:
            return [z[f"arr_{i}"] for i in range(4)] + [z["scaler"]]

    yield read
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


# -- tables -------------------------------------------------------------------------------

def test_regions_equal_jax():
    assert regions.STATE_CODE_TO_NAME == jax_regions.STATE_CODE_TO_NAME
    assert regions.STATE_CODES == jax_regions.STATE_CODES == jax_synthetic.US_STATE_CODES
    assert regions.STATE_NAMES == jax_regions.STATE_NAMES == jax_synthetic.US_STATE_NAMES
    assert regions.HHS_REGION_STATES == jax_regions.HHS_REGION_STATES
    assert regions.N_REGIONS == jax_regions.N_REGIONS
    assert "MT" in regions.HHS_REGION_STATES[1] and "MT" in regions.HHS_REGION_STATES[8]
    assert len(regions.STATE_CODES) == 49 and "FL" not in regions.STATE_CODES


def test_floats_parse_as_pandas_parses(tmp_path):
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.uniform(0, 20, 400), rng.lognormal(0, 12, 400),
                             -rng.uniform(0, 1, 200) * 10.0 ** rng.integers(-12, 12, 200)])
    cells = [repr(float(v)) for v in values] + [
        "0.1", "-0.0", "0", "007", ".5", "5.", "+3.25", "1e-05", "1.5E+20", "2.5e-310",
        "123456789012345678901234", "0.000012345678901234567891", "99999999999999999.5",
        "", "nan", "NaN", "inf", "-inf", "3"]
    path = tmp_path / "floats.csv"
    path.write_text("x\n" + "\n".join(f'"{c}"' if c == "" else c for c in cells) + "\n")
    want = pd.read_csv(path)["x"].to_numpy(np.float64)
    got = tables.floats_of(cells, str(path))
    assert np.array_equal(got, want, equal_nan=True)
    assert not np.array_equal(got[:1000], values)       # pandas is not float() everywhere
    with pytest.raises(ValueError, match=r"floats\.csv, row 3: '1\.2\.3'"):
        tables.floats_of(["1", "1.2.3"], str(path))


def test_every_file_reads_as_pandas_reads_it(trees):
    root = trees["jax"]
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    assert len(files) == 57          # 6 tables, 50 state query files, the national one
    for path in files:
        name = os.path.basename(path)
        if name.endswith("_flu.csv"):
            df = pd.read_csv(path, index_col=-1, parse_dates=True)
            header, columns = tables.read_columns(path)
            dates = tables.dates_of(columns[-1], path)
            assert np.array_equal(dates, df.index.values.astype("datetime64[D]")), name
            for c in df.columns:
                if df[c].dtype.kind in "fi":
                    got = tables.floats_of(columns[header.index(c)], path)
                    assert np.array_equal(got, df[c].to_numpy(np.float64)), (name, c)
            continue
        if name in ("Dates.csv", "state_population_data_2019.csv"):
            continue
        df = pd.read_csv(path, index_col=0, parse_dates=name != "Similarity_Scores.csv")
        frame = tables.read_frame(path, parse_dates=name != "Similarity_Scores.csv")
        assert frame.columns == tuple(df.columns), name
        assert np.array_equal(frame.values, df.to_numpy(np.float64)), name
        if name != "Similarity_Scores.csv":
            assert np.array_equal(frame.index, df.index.values.astype("datetime64[D]")), name


@pytest.mark.parametrize("bad", ["2010/10/01", "2010-10-1", "2010-10-01 12:00:00", "x"])
def test_dates_must_be_iso(tmp_path, bad):
    path = tmp_path / "q.csv"
    path.write_text(f",a\n2010-09-30,1.0\n{bad},2.0\n")
    with pytest.raises(ValueError, match=r"q\.csv, row 3: .* is not an ISO date"):
        tables.read_frame(str(path))


def test_dates_take_a_midnight_time(tmp_path):
    path = tmp_path / "q.csv"
    path.write_text(",a\n2010-09-30 00:00:00,1.0\n2010-10-01,2.0\n")
    frame = tables.read_frame(str(path))
    assert list(frame.index) == [np.datetime64("2010-09-30"), np.datetime64("2010-10-01")]


def test_writer_writes_the_jax_files_byte_for_byte(trees):
    cmp = filecmp.dircmp(trees["jax"], trees["port"])
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    sub = cmp.subdirs["Queries"]
    assert not sub.diff_files and not sub.subdirs["state_queries"].diff_files
    assert len(sub.subdirs["state_queries"].same_files) == 50


# -- the pipeline's pieces ------------------------------------------------------------------

def frame_equal(port, df):
    assert port.columns == tuple(df.columns)
    assert np.array_equal(port.index, df.index.values.astype("datetime64[D]"))
    assert np.array_equal(port.values, df.to_numpy(np.float64), equal_nan=True)


@pytest.mark.parametrize("region", ["US", "hhs", "state"])
def test_load_and_interpolate_equal_jax(trees, region):
    ili_j = jax_builder.load_ili(region, trees["jax"])
    ili_p = builder.load_ili(region, trees["jax"])
    frame_equal(ili_p, ili_j)
    for fill_1 in (False, True):
        frame_equal(builder.interpolate_ili(ili_p, fill_1=fill_1),
                    jax_builder.interpolate_ili(ili_j, fill_1=fill_1))
    frame_equal(builder.smooth(ili_p, n=3), jax_builder.smooth(ili_j, n=3))


def test_load_ili_aligns_later_regions_by_date(tmp_path):
    """Regions in order of first appearance; the first region's dates are the
    index, a later region's rows align by date (any order), gaps are 0."""
    (tmp_path / "hhs_flu.csv").write_text(
        "region,unweighted_ili,date\nRegion 2,1.3,2010-10-01\nRegion 2,2.6,2010-10-08\n"
        "Region 1,3.9,2010-10-08\nRegion 2,6.5,2010-10-15\nRegion 1,5.2,2010-10-22\n")
    frame_equal(builder.load_ili("hhs", str(tmp_path)),
                jax_builder.load_ili("hhs", str(tmp_path)))


@pytest.mark.parametrize("num", range(1, 11))
def test_hhs_query_data_equals_jax(trees, num):
    kw = dict(ignore=("VI", "PR", "CT"), smooth_after=True)
    frame_equal(builder.get_hhs_query_data(num, trees["jax"], **kw),
                jax_builder.get_hhs_query_data(num, trees["jax"], **kw))


@pytest.mark.parametrize("region,nums", [("US", [1]), ("hhs", range(1, 11)),
                                         ("state", [1, 9, 24, 49])])
def test_choose_qs_equals_jax(trees, region, nums):
    root = trees["jax"]
    ili_j = jax_builder.interpolate_ili(jax_builder.load_ili(region, root))
    ili_p = builder.interpolate_ili(builder.load_ili(region, root))
    for num in nums:
        if region == "US":
            qj, qp = jax_builder.get_nat_query_data(num, root), builder.get_nat_query_data(num, root)
        elif region == "hhs":
            qj = jax_builder.get_hhs_query_data(num, root, smooth_after=True)
            qp = builder.get_hhs_query_data(num, root, smooth_after=True)
        else:
            qj = jax_builder.get_state_query_data(num, root, smooth_after=True)
            qp = builder.get_state_query_data(num, root, smooth_after=True)
        for n_qs in (3, 6):
            want = list(jax_builder.choose_qs({num: qj}, ili_j, num, SEASON, n_qs,
                                              region=region, root=root))
            assert list(builder.choose_qs({num: qp}, ili_p, num, SEASON, n_qs, region=region,
                                          root=root)) == want


def test_choose_qs_breaks_ties_as_pandas(tmp_path, trees):
    """Equal scores fall in the order of numpy's quicksort over the file's rows:
    three copies of one query under one similarity tie; a query with no
    similarity row is dropped."""
    root = tmp_path / "Data"
    root.mkdir()
    (root / "Similarity_Scores.csv").write_text(
        ",similarity\n" + "".join(f"query_{i},0.6\n" for i in range(5)))
    ili_j = jax_builder.interpolate_ili(jax_builder.load_ili("US", trees["jax"]))
    ili_p = builder.interpolate_ili(builder.load_ili("US", trees["jax"]))
    qj = jax_builder.get_nat_query_data(1, trees["jax"])
    qp = builder.get_nat_query_data(1, trees["jax"])
    for copy in ("query_1", "query_3"):
        qj[copy] = qj["query_0"]
        qp.values[:, qp.columns.index(copy)] = qp.column("query_0")
    want = list(jax_builder.choose_qs({1: qj}, ili_j, 1, SEASON, 6, region="US", root=str(root)))
    assert list(builder.choose_qs({1: qp}, ili_p, 1, SEASON, 6, region="US",
                                  root=str(root))) == want and len(want) == 5


def test_folds_and_arrays_equal_jax():
    for n, k, seed in ((23, 5, 0), (10, 3, 4)):
        for (tr_p, va_p), (tr_j, va_j) in zip(loader.return_folds(n, k, seed),
                                               jax_loader.return_folds(n, k, seed)):
            assert np.array_equal(tr_p, tr_j) and np.array_equal(va_p, va_j)
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((9, 3, 2)), rng.standard_normal((9, 4, 2)),
              rng.standard_normal((5, 3, 2)), rng.standard_normal((5, 4, 2))]
    lp, *test_p = loader.convert_to_arrays(*arrays, batch_size=4, seed=3)
    lj, *test_j = jax_loader.convert_to_arrays(*arrays, batch_size=4, seed=3)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype == np.float32
               for a, b in zip(test_p, test_j))
    for (xp, yp), (xj, yj) in zip(lp, lj):
        assert np.array_equal(xp, xj) and np.array_equal(yp, yj)
    assert len(lp) == len(lj) == 3


# -- DataConstructor ---------------------------------------------------------------------------

def assert_same_build(got, want):
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a, b)
    assert got[4].dtype == np.float64 and np.array_equal(got[4], want[4])


@pytest.mark.parametrize("region,combo", [("US", c) for c in COMBOS] + [("hhs", c) for c in COMBOS]
                         + [("state", (True, True, False)), ("state", (True, True, True))])
def test_data_constructor_equals_jax(trees, jax_runs, region, combo):
    rb, nq, f1 = combo
    got = builder.DataConstructor(SEASON, region, n_queries=N_QUERIES, root=trees["jax"],
                                  fill_1=f1)(run_backward=rb, no_qs_in_output=nq)
    R = regions.N_REGIONS[region]
    assert got[0].shape[1:] == (28 + 14, R * (N_QUERIES + 1))
    assert got[1].shape[1:] == ((28 + 1 + 28) if rb else 28, R if nq else R * (N_QUERIES + 1))
    assert_same_build(got, jax_runs(job_name("jax", region, rb, nq, f1)))
    if f1:
        assert (got[1][..., -R:] == -1.0).mean() > 0.5     # most daily targets are gaps


def test_jax_constructor_reads_the_port_tree_to_the_same_arrays(jax_runs):
    assert_same_build(jax_runs(job_name("port", "US", True, True, False)),
                      jax_runs(job_name("jax", "US", True, True, False)))


def test_data_constructor_refuses_what_the_reference_refuses(trees):
    with pytest.raises(ValueError, match="England"):
        builder.DataConstructor(SEASON, "England", root=trees["jax"])
    with pytest.raises(KeyError, match="no season 2016"):      # Dates.csv ends at 2015
        builder.DataConstructor(2016, "US", n_queries=3, root=trees["jax"])(True, True)
