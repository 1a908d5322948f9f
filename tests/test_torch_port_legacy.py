"""The port's legacy national pipeline (``fiude_tpu_torch.data.legacy``, the
legacy tree writer and ``load_ili("England")``) against the JAX package's, on
the CPU, without the reference's files.

* the port's ``write_legacy_national_tree`` writes the JAX writer's files
  byte for byte;
* ``legacy_national_data`` equals the JAX function's arrays bit for bit
  (England and US, 0 and 6 queries, ``rescale`` off and on);
* ``load_legacy_queries`` gives the same names in the same order and the
  same values, on the synthetic tree and on a hand-made tree with a tied
  rating, an all-NaN column, a column of zeros, colliding renames, a
  repeated header name, repeated and unsorted dates and an all-NaN row;
* ``load_ili("England")`` equals the JAX one on a hand-written
  ``England_ILIrates.csv`` (day-first dates);
* the port refuses a date that is not ISO and ragged windows where the
  reference fails on them.
"""
import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

from fiude_tpu.data import builder as jax_builder
from fiude_tpu.data import legacy as jax_legacy
from fiude_tpu.data import synthetic as jax_synthetic

from fiude_tpu_torch.data import builder, legacy, synthetic

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("legacy")
    jax_synthetic.write_legacy_national_tree(str(base / "jax"), n_qs=6, seed=0)
    synthetic.write_legacy_national_tree(str(base / "port"), n_qs=6, seed=0)
    return {"jax": str(base / "jax"), "port": str(base / "port"), "base": base}


def assert_same_frame(port, jax_frame):
    assert list(port.columns) == list(jax_frame.columns)
    assert np.array_equal(port.index, jax_frame.index.values.astype("datetime64[D]"))
    assert np.array_equal(port.values, jax_frame.values, equal_nan=True)


def test_writer_writes_the_jax_files_byte_for_byte(trees):
    names = sorted(os.listdir(trees["jax"]))
    assert names == sorted(os.listdir(trees["port"])) and len(names) == 7
    for name in names:
        assert filecmp.cmp(os.path.join(trees["jax"], name), os.path.join(trees["port"], name),
                           shallow=False), name


@pytest.mark.parametrize("rescale", [None, True])
@pytest.mark.parametrize("n_queries", [0, 6])
@pytest.mark.parametrize("country", ["England", "US"])
def test_legacy_national_data_equals_jax(trees, country, n_queries, rescale):
    kw = dict(country=country, n_queries=n_queries, rescale=rescale, window=12, gamma=6,
              year=2016, data_season=2015)
    want = jax_legacy.legacy_national_data(trees["jax"], **kw)
    got = legacy.legacy_national_data(trees["jax"], **kw)
    assert len(got) == len(want) == (7 if n_queries else 5)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g, w)
    assert isinstance(got[-1], float) and got[-1] == want[-1]


@pytest.mark.parametrize("country", ["England", "US"])
def test_load_legacy_queries_equals_jax_on_the_synthetic_tree(trees, country):
    for n in (3, 6):
        assert_same_frame(legacy.load_legacy_queries(trees["jax"], 2015, country, n),
                          jax_legacy.load_legacy_queries(trees["jax"], 2015, country, n))


def write_hand_tree(root):
    """A UK tree whose query table needs every cleaning rule."""
    os.makedirs(root)
    rng = np.random.default_rng(3)
    days = np.arange(np.datetime64("2011-06-01"), np.datetime64("2015-03-01"))
    n = len(days)
    ili = np.abs(np.sin(np.arange(n) / 50.0)) * 3 + rng.uniform(0, 0.1, n)
    with open(f"{root}/ILI_rates_UK_thursday_cubic_interpolation.csv", "w") as f:
        f.write(",wILI\n" + "".join(f"{d},{float(v)!r}\n" for d, v in zip(days, ili)))
    # "flu+symptoms" and "symptoms flu" collide (the first kept), "a" is there twice
    # (read as "a" and "a.1"), "a" and "b" tie, "empty" is all NaN (kept, ranked last),
    # "zero" has max 0 (dropped)
    names = ["flu+symptoms", "symptoms flu", '"cold,fever"', "empty", "zero", "a", "b", "a"]
    cols = [ili * 2 + 1, ili * 3, np.cos(np.arange(n) / 7.0) + 2, np.full(n, np.nan),
            np.zeros(n), ili + 0.5, ili + 0.5, rng.uniform(0, 1, n)]
    lines = ["," + ",".join(names)]
    for i in list(range(n)) + [5, 17]:          # two dates again, other values: the first kept
        shift = 0.25 if len(lines) > n else 0.0
        lines.append(f"{days[i]}," + ",".join(
            "" if np.isnan(c[i]) else repr(float(c[i]) + shift) for c in cols))
    lines.insert(40, "2010-01-01," + ",".join([""] * len(names)))   # all NaN, out of order
    with open(f"{root}/UK_Qs_small_7day_avg.csv", "w") as f:
        f.write("\n".join(lines) + "\n")
    sims = {"flu symptoms": 0.5, "cold fever": 0.9, "empty": 0.4, "zero": 0.3, "a": 0.7,
            "b": 0.7, "a.1": 0.2}
    with open(f"{root}/UK_Similarity_Scores.csv", "w") as f:
        f.write(",similarity\n" + "".join(f"{k},{v}\n" for k, v in sims.items()))


def test_load_legacy_queries_cleans_and_ranks_as_pandas(tmp_path):
    root = str(tmp_path / "hand")
    write_hand_tree(root)
    want = jax_legacy.load_legacy_queries(root, 2014, "England", 10)
    got = legacy.load_legacy_queries(root, 2014, "England", 10)
    assert list(want.columns) == ["a", "b", "flu symptoms", "cold fever", "a.1", "empty"]
    assert_same_frame(got, want)
    assert np.isnan(got.values[:, -1]).all()


def test_load_ili_england_equals_jax(tmp_path):
    root = tmp_path / "Data"
    root.mkdir()
    rng = np.random.default_rng(1)
    starts = np.datetime64("2014-09-29") + 7 * np.arange(30)
    rows = [f"{2014 + (k > 12)},{k % 52 + 1},{str(d)[8:]}/{str(d)[5:7]}/{str(d)[:4]},"
            f"{float(v)!r},England" for k, (d, v) in enumerate(zip(starts, rng.uniform(0, 40, 30)))]
    (root / "England_ILIrates.csv").write_text(
        "ISOYear,ISOWeek,ISOWeekStartDate,RatePer100000,Country\n" + "\n".join(rows) + "\n")
    want = jax_builder.load_ili("England", str(root))
    got = builder.load_ili("England", str(root))
    assert got.columns == ("National",) and list(want.columns) == ["National"]
    assert np.array_equal(got.index, want.index.values.astype("datetime64[D]"))
    assert np.array_equal(got.values, want.values)
    assert str(got.index[0]) == "2014-10-02"                  # ISOWeekStartDate + 3 days


def test_builder_points_england_to_the_legacy_pipeline(trees):
    with pytest.raises(ValueError, match=r"legacy_national_data\(country='England'\)"):
        builder.DataConstructor(2016, "England", root=trees["jax"])
    with pytest.raises(ValueError, match="fiude_tpu_torch.data.legacy"):
        builder.load_ili("Wales", trees["jax"])


def test_unknown_year_raises(trees):
    with pytest.raises(ValueError, match="legacy season anchors"):
        legacy.legacy_national_data(trees["jax"], country="England", year=1999)


def copy_tree(trees, name):
    dst = trees["base"] / name
    shutil.copytree(trees["jax"], dst)
    return str(dst)


def edit_national_flu(root, edit):
    path = os.path.join(root, "national_flu.csv")
    with open(path) as f:
        lines = f.read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(edit(lines)) + "\n")


def test_a_date_that_is_not_iso_is_refused(trees):
    root = copy_tree(trees, "bad_date")
    edit_national_flu(root, lambda lines: lines[:500] + [lines[500].rsplit(",", 1)[0]
                                                         + ",2006-13-45"] + lines[501:])
    with pytest.raises(Exception):
        jax_legacy.legacy_national_data(root, country="US")
    with pytest.raises(ValueError, match="not an ISO date"):
        legacy.legacy_national_data(root, country="US")


def test_ragged_windows_are_refused(trees):
    root = copy_tree(trees, "ragged")
    edit_national_flu(root, lambda lines: lines[:700] + lines[701:])    # a week of 2010 gone
    with pytest.raises(ValueError):
        jax_legacy.legacy_national_data(root, country="US")
    with pytest.raises(ValueError, match="unequal length"):
        legacy.legacy_national_data(root, country="US")
