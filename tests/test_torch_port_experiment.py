"""The port's experiment recipes against the JAX package's, on the CPU: the
path from an ``ExperimentConfig`` through the growing-horizon curriculum to a
row of the results table.

* data: ``synthetic_dataset`` (numpy windows) equal bit for bit to the JAX
  package's (windows built by its C++ library);
* config: ``ExperimentConfig.key``, ``model_kwargs``, ``as_row``, ``grid`` and
  ``reference_main_grid`` (7200 configs) equal;
* metrics: ``mae``, ``mb_log``, ``skill``, ``nll`` and ``evaluate_forecast``
  equal on the same arrays (rtol 1e-12);
* the results table: what either package's ``upsert_results_row`` writes, the
  other reads, matches rows in and updates (the port without pandas and
  ``filelock``); a killed writer leaves the old table
  (mirrors ``tests/test_experiment.py::TestAtomicCSV``);
* real data: ``_build_data`` for a ``Data/`` tree (the port's writer, ``hhs``,
  ``fill_1`` both ways) equal bit for bit to the JAX package's, and
  ``run_experiment(data_root=)`` trained to a results row on the CPU;
* the schedule: the calls ``run_experiment`` and ``run_transfer`` make to
  ``Trainer.train`` / ``train_curriculum_padded`` (grids, ``eval_pts``, epochs a
  stage, ``grad_lim``, ``fa_w``) equal the JAX functions', by recording them in
  both packages;
* end to end at a tiny size, ``device="cpu"``: exact, padded and ``fused_train``
  modes and the transfer (mirrors ``TestRunExperiment``,
  ``TestAdaptiveCurriculum``); checkpoints written by one package's
  ``run_experiment`` load through the other's ``run_transfer``.

End-of-run losses are not compared across the packages: the eps draws differ
and training is chaotic.
"""
import os

import numpy as np
import pandas as pd
import pytest

import jax
import torch

from fiude_tpu.data import synthetic as jax_synthetic
from fiude_tpu.train import experiment as jax_experiment
from fiude_tpu.train.trainer import Trainer as JaxTrainer
from fiude_tpu.utils import config as jax_config
from fiude_tpu.utils import metrics as jax_metrics
from fiude_tpu.utils import results as jax_results

from fiude_tpu_torch.data import ArrayLoader, synthetic
from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, experiment
from fiude_tpu_torch.train.checkpoint import PARTS, flat_from_module, load_flat, param_map
from fiude_tpu_torch.utils import config, metrics, results

torch.set_num_threads(1)

SMALL_REGION = {
    "n_regions": 1, "latent_dim": 6, "n_qs": 3,
    "ode_params": {"net_sizes": (10, 10), "aug_net_sizes": (10, 10)},
    "dec_params": {},
    "enc_params": {"q_sizes": (12,), "ff_sizes": (8,)},
    "epochs": 8,
}


@pytest.fixture(autouse=True)
def small_region_preset():
    config.REGION_INFO["tiny"] = SMALL_REGION
    jax_config.REGION_INFO["tiny"] = SMALL_REGION
    yield
    config.REGION_INFO.pop("tiny", None)
    jax_config.REGION_INFO.pop("tiny", None)


def tiny_kw(**kw):
    base = dict(region="tiny", ode_name="CONN", test_season=2016, epochs=8, window_size=7,
                gamma=28, latent_dim=6, num=1, batch_size=16, n_samples=4)
    base.update(kw)
    return base


def tiny_cfg(**kw):
    return config.ExperimentConfig(**tiny_kw(**kw))


# -- data, config, metrics -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_regions=1, n_qs=4, window_size=28, gamma=28, seed=0),
    dict(n_regions=3, n_qs=2, window_size=7, gamma=14, seed=5),
    dict(n_regions=2, n_qs=5, window_size=1, gamma=35, seed=7919 * 16 + 2, n_seasons=2,
         season_len=120, run_backward=False),
])
def test_synthetic_dataset_equals_jax_bit_for_bit(kw):
    got = synthetic.synthetic_dataset(**kw)
    want = jax_synthetic.synthetic_dataset(**kw)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert len(got[0]) > 0 and len(got[2]) > 0


def test_config_equals_jax():
    assert config.REGION_INFO == jax_config.REGION_INFO
    assert config.ODE_NAMES == jax_config.ODE_NAMES
    for kw in (dict(), dict(region="state", ode_name="UONNb", test_season=2018, epochs=140,
                            window_size=22, gamma=49, num=17)):
        got, want = config.ExperimentConfig(**kw), jax_config.ExperimentConfig(**kw)
        assert got.key == want.key
        assert got.model_kwargs() == want.model_kwargs()
        assert got.as_row() == want.as_row()
        assert (got.n_regions, got.n_qs) == (want.n_regions, want.n_qs)
    got, want = config.reference_main_grid(), jax_config.reference_main_grid()
    assert len(got) == len(want) == 7200
    assert [c.key for c in got] == [c.key for c in want]
    axes = dict(region=["US", "hhs"], num=[1, 2, 3])
    assert [c.as_row() for c in config.grid(**axes)] == \
        [c.as_row() for c in jax_config.grid(**axes)]


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    true = rng.uniform(0, 8, (30, 4))
    mean = true + rng.normal(0, 0.7, true.shape)
    std = rng.uniform(0.05, 1.5, true.shape)
    std[0, 0] = 1e-3          # a zero-probability bin: the floor
    mean[0, 0] = true[0, 0] + 5.0
    for name in ("nll", "mae", "mb_log", "skill"):
        np.testing.assert_allclose(getattr(metrics, name)(true, mean, std),
                                   getattr(jax_metrics, name)(true, mean, std),
                                   rtol=1e-12, atol=0, err_msg=name)
    assert metrics.mb_log(true, mean, std)[0, 0] == np.log(4.5399929762484854e-05)


def test_evaluate_forecast_equals_jax():
    rng = np.random.default_rng(1)
    y_pred = rng.uniform(0, 1, (6, 16, 36, 3))
    y_test = rng.uniform(0, 1, (6, 36, 3))
    scaler = np.array([3.0, 7.7, 5.1], np.float32)
    kw = dict(window_size=7, test_season=2017)
    got = results.evaluate_forecast(y_pred, y_test, scaler, **kw)
    want = jax_results.evaluate_forecast(y_pred, y_test, scaler, **kw)
    assert list(got) == list(want) == [
        "2017 13", "skill 2017 7", "2017 20", "skill 2017 14", "2017 27", "skill 2017 21",
        "2017 34", "skill 2017 28"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


# -- the results table ------------------------------------------------------------------

VARS = [{"epochs": 4, "gamma": 28, "ode_name": "CONN", "region": "state", "latent_dim": 8,
         "window_size": 28, "num": 0},
        {"epochs": 4, "gamma": 28, "ode_name": "UONN", "region": "state", "latent_dim": 8,
         "window_size": 28, "num": 0}]
VALUES = [{"2016 34": 1.2345678901234567, "skill 2016 7": 0.25},
          {"2016 34": -0.5, "skill 2016 7": 1e-5},
          {"2016 34": 7.0, "skill 2016 7": 0.125, "2017 34": 3.5}]


def assert_same_table(path_a, path_b):
    a, b = (pd.read_csv(p, index_col=0) for p in (path_a, path_b))
    assert list(a.columns) == list(b.columns) and list(a.index) == list(b.index)
    for col in a.columns:
        if not pd.api.types.is_numeric_dtype(a[col]):
            assert list(a[col]) == list(b[col])
        else:
            np.testing.assert_array_equal(a[col].to_numpy(float), b[col].to_numpy(float))


@pytest.mark.parametrize("writers", ["port,port,port", "jax,port,port", "port,jax,jax",
                                     "jax,port,jax"])
def test_results_table_round_trip_with_jax(tmp_path, writers):
    """Three upserts (a row, a second row, an update of the first with a new
    column) by any mix of the two packages give the table the JAX package
    alone writes."""
    upsert = {"port": results.upsert_results_row, "jax": jax_results.upsert_results_row}
    mixed, ref = str(tmp_path / "mixed"), str(tmp_path / "ref")
    for who, variables, values in zip(writers.split(","), (VARS[0], VARS[1], VARS[0]), VALUES):
        upsert[who](mixed, variables, values)
        jax_results.upsert_results_row(ref, variables, values)
    assert_same_table(mixed + ".csv", ref + ".csv")
    df = pd.read_csv(mixed + ".csv", index_col=0)
    assert len(df) == 2 and df.loc[0, "2016 34"] == 7.0 and df.loc[0, "2017 34"] == 3.5
    assert df.loc[1, "2016 34"] == -0.5 and np.isnan(df.loc[1, "2017 34"])
    columns, index, rows = results.read_table(mixed + ".csv")
    assert index == [0, 1] and rows[0]["ode_name"] == "CONN" and "2017 34" not in rows[1]
    assert rows[0]["2016 34"] == 7.0 and rows[1]["skill 2016 7"] == 1e-5


def test_upsert_matches_on_every_variable(tmp_path):
    name = str(tmp_path / "t")
    results.upsert_results_row(name, {"a": 1, "b": "x"}, {"v": 1.0})
    results.upsert_results_row(name, {"a": 1, "b": "y"}, {"v": 2.0})
    results.upsert_results_row(name, {"a": 1, "b": "x"}, {"v": 3.0})
    results.upsert_results_row(name, {"a": 1, "c": 0}, {"v": 4.0})     # a new variable: a new row
    df = pd.read_csv(name + ".csv", index_col=0)
    assert list(df["v"]) == [3.0, 2.0, 4.0] and list(df.index) == [0, 1, 2]


def test_killed_writer_leaves_the_old_table(tmp_path, monkeypatch):
    """Mirrors ``tests/test_experiment.py::TestAtomicCSV``: a kill after the temp
    file is opened and before any bytes land must not truncate the table."""
    name = str(tmp_path / "t")
    results.upsert_results_row(name, {"a": 1}, {"v": 1.0})
    real_replace = os.replace

    def killed(src, dst):
        open(src, "w").close()
        raise KeyboardInterrupt

    monkeypatch.setattr(results.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        results.upsert_results_row(name, {"a": 1}, {"v": 2.0})
    monkeypatch.setattr(results.os, "replace", real_replace)
    df = pd.read_csv(name + ".csv", index_col=0)
    assert df.loc[0, "v"] == 1.0                       # the old table, whole
    results.upsert_results_row(name, {"a": 1}, {"v": 5.0})      # the lock was released
    assert pd.read_csv(name + ".csv", index_col=0).loc[0, "v"] == 5.0
    leftovers = [p.name for p in tmp_path.glob("*.tmp.*")]
    assert len(leftovers) <= 1     # only the killed writer's own, as in the JAX package


# -- the schedule --------------------------------------------------------------------------

def record_calls(monkeypatch, cls, log):
    """Replace ``cls``'s training, saving and loading by recorders."""
    def train(self, loader, t, epochs, eval_pts, **kw):
        log.append(("train", float(self.fa_w), [round(float(v), 6) for v in np.asarray(t)],
                    int(epochs), [int(v) for v in np.asarray(eval_pts)], float(kw["grad_lim"]),
                    int(kw["n_samples"]), bool(kw.get("checkpoint")), len(loader),
                    kw.get("validate") is not None))

    def padded(self, loader, t, eval_all, epochs_per_stage, **kw):
        log.append(("padded", float(self.fa_w), [round(float(v), 6) for v in np.asarray(t)],
                    int(epochs_per_stage), [int(v) for v in np.asarray(eval_all)],
                    float(kw["grad_lim"]), int(kw["n_samples"]), bool(kw.get("checkpoint")),
                    len(loader), kw.get("validate") is not None))

    monkeypatch.setattr(cls, "train", train)
    monkeypatch.setattr(cls, "train_curriculum_padded", padded)
    monkeypatch.setattr(cls, "pre_train",
                        lambda self, loader, epochs, lr: log.append(("pre_train", epochs, lr)))
    monkeypatch.setattr(cls, "save", lambda self, *a, **k: log.append(("save",)))
    def load(self, *a, **k):
        log.append(("load", k.get("file_prefix")))
        if cls is Trainer:         # the port's run_transfer checks what was copied
            return [key for part in PARTS for key, _, _ in param_map(self.model, part)]

    monkeypatch.setattr(cls, "load", load)


@pytest.mark.parametrize("cfg_kw,run_kw", [
    (dict(), dict()),
    (dict(epochs=3, gamma=35), dict()),                        # epochs a stage clamped to 1
    (dict(epochs=9), dict(padded_curriculum=True)),
    (dict(epochs=5), dict(curriculum=False)),
    (dict(epochs=8, grad_lim=1234.0), dict(pre_train_epochs=2, validate_each_epoch=True,
                                           n_samples=7)),
])
def test_run_experiment_schedule_equals_jax(monkeypatch, tmp_path, cfg_kw, run_kw):
    got, want = [], []
    record_calls(monkeypatch, Trainer, got)
    record_calls(monkeypatch, JaxTrainer, want)
    kw = dict(synthetic=True, weights_root=str(tmp_path), **run_kw)
    experiment.run_experiment(tiny_cfg(**cfg_kw), device="cpu", **kw)
    jax_experiment.run_experiment(jax_config.ExperimentConfig(**tiny_kw(**cfg_kw)), **kw)
    assert got == want and len(got) >= 2 and got[-1] == ("save",)


def test_run_transfer_schedule_equals_jax(monkeypatch, tmp_path):
    got, want = [], []
    record_calls(monkeypatch, Trainer, got)
    record_calls(monkeypatch, JaxTrainer, want)
    kw = dict(load_prefix="somewhere/", synthetic=True, weights_root=str(tmp_path),
              warm_epochs=2, ramp_epochs_each=3, final_epochs=4)
    tr = experiment.run_transfer(tiny_cfg(ode_name="UONN"), device="cpu", **kw)
    jax_experiment.run_transfer(jax_config.ExperimentConfig(**tiny_kw(ode_name="UONN")), **kw)
    assert got == want
    assert [c[1] for c in got if c[0] == "train"] == \
        [0.0, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.0]
    assert all(c[5] == 1500.0 for c in got if c[0] == "train") and tr.fa_w == 1.0


def test_build_trainer_settings_equal_jax(tmp_path):
    for name in ("UONN", "CONNb"):
        pt = experiment.build_trainer(tiny_cfg(ode_name=name, num=3), seed=4, fused_train=True,
                                      weights_root=str(tmp_path), device="cpu")
        jt = jax_experiment.build_trainer(
            jax_config.ExperimentConfig(**tiny_kw(ode_name=name, num=3)), seed=4,
            fused_train=True, weights_root=str(tmp_path))
        assert pt.model.fused_train and pt.model.fused_stats
        assert jt.model.fused_train and jt.model.fused_stats
        assert (pt.len_tr, pt.seed, pt.file_prefix, pt.chkpt_prefix) == \
            (jt.len_tr, jt.seed, jt.file_prefix, jt.chkpt_prefix) and pt.len_tr == 130
        assert pt.ode_kl_w == jt.ode_kl_w == (1 / 153 if name == "CONNb" else None)
        assert pt.loss_cfg.ode_kl_w == jt.loss_cfg.ode_kl_w


@pytest.fixture(scope="module")
def hhs_tree(tmp_path_factory):
    """A ``Data/`` tree from the port's writer, with the 15 queries the ``hhs``
    preset selects and one more (300 weeks: seasons 2012-2015 in Dates.csv)."""
    root = str(tmp_path_factory.mktemp("Data"))
    synthetic.write_reference_data_tree(root, n_qs=16, seed=0, n_weeks=300)
    return root


@pytest.mark.parametrize("fill_1", [False, True])
def test_real_data_builds_the_jax_arrays(hhs_tree, fill_1):
    """``_build_data`` for a ``Data/`` tree (``synthetic=False``): the port's
    ``DataConstructor`` under the reference's arguments, bit for bit the
    arrays of the JAX package's ``_build_data``."""
    kw = dict(region="hhs", ode_name="UONN", test_season=2014, window_size=28, gamma=28)
    got = experiment._build_data(config.ExperimentConfig(**kw), hhs_tree, False, fill_1)
    want = jax_experiment._build_data(jax_config.ExperimentConfig(**kw), hhs_tree, False, fill_1)
    assert got[0].shape[1:] == (42, 10 * 16) and got[1].shape[1:] == (57, 10)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(got[4], want[4].to_numpy())


def test_run_experiment_trains_on_a_data_tree(hhs_tree, tmp_path, monkeypatch):
    """``run_experiment(data_root=)`` end to end on the CPU, ``fill_1`` and the
    sweeps' mode (padded curriculum, ``fused_train``): the whole data path at
    the ``hhs`` preset's 10 regions and 15 queries, the model narrowed (the
    ``tiny`` widths), 3 steps an epoch, to a results row."""
    monkeypatch.setitem(config.REGION_INFO, "hhs", dict(SMALL_REGION, n_regions=10, n_qs=15))
    cfg = config.ExperimentConfig(region="hhs", ode_name="UONN", test_season=2014, epochs=4,
                                  window_size=7, gamma=28, latent_dim=6, batch_size=512,
                                  n_samples=4)
    out = experiment.run_experiment(
        cfg, data_root=hhs_tree, fill_1=True, padded_curriculum=True, fused_train=True,
        weights_root=str(tmp_path), results_file=str(tmp_path / "results_table"), device="cpu")
    steps = [len(epoch) for epoch in out["trainer"].history.batch_history]
    assert steps == [3] * 4 and np.isfinite([h["loss"] for h in out["history"]]).all()
    df = pd.read_csv(str(tmp_path / "results_table.csv"), index_col=0)
    assert len(df) == 1 and df.loc[0, "region"] == "hhs"
    for g, w in zip((13, 20, 27, 34), (7, 14, 21, 28)):
        assert np.isfinite(df.loc[0, f"2014 {g}"]) and np.isfinite(df.loc[0, f"skill 2014 {w}"])


def test_daily_grid_is_float64_and_uniform():
    t = experiment.daily_grid(tiny_cfg())
    assert t.dtype == np.float64 and len(t) == 36 and t[7] == 1.0
    assert len(set(np.diff(t).astype(np.float32).tolist())) == 1


# -- end to end --------------------------------------------------------------------------

class TestRunExperiment:
    def test_curriculum_sweep_unit(self, tmp_path):
        cfg = tiny_cfg()
        out = experiment.run_experiment(
            cfg, synthetic=True, weights_root=str(tmp_path),
            results_file=str(tmp_path / "results_table"), device="cpu")
        assert len(out["history"]) == 8                       # 4 stages x 2 epochs
        assert np.isfinite(out["history"][-1]["loss"])
        assert os.path.exists(str(tmp_path / "weights" / cfg.key) + "enc.npz")
        assert os.path.exists(str(tmp_path / "chkpts" / cfg.key) + "chkpt_ode.npz")
        assert os.path.exists(str(tmp_path / "norms" / cfg.key) + "norms.txt")
        df = pd.read_csv(str(tmp_path / "results_table.csv"), index_col=0)
        assert len(df) == 1
        for g, w in zip((13, 20, 27, 34), (7, 14, 21, 28)):
            assert np.isfinite(df.loc[0, f"2016 {g}"]) and np.isfinite(df.loc[0, f"skill 2016 {w}"])
        assert set(out["metrics"]) == set(df.columns) - {
            "epochs", "gamma", "ode_name", "region", "latent_dim", "window_size", "num"}
        # a second run of the config updates its row
        experiment.run_experiment(
            tiny_cfg(epochs=4), synthetic=True, weights_root=str(tmp_path),
            results_file=str(tmp_path / "results_table"), device="cpu")
        experiment.run_experiment(
            cfg, synthetic=True, weights_root=str(tmp_path), seed=1,
            results_file=str(tmp_path / "results_table"), device="cpu")
        df2 = pd.read_csv(str(tmp_path / "results_table.csv"), index_col=0)
        assert len(df2) == 2 and list(df2["epochs"]) == [8, 4]
        assert df2.loc[0, "2016 13"] != df.loc[0, "2016 13"]

    @pytest.mark.parametrize("ode_name", ["UONN", "UONNb"])
    def test_padded_fused_mode(self, tmp_path, ode_name):
        """The sweeps' mode: the padded curriculum through ``fused_train`` with
        ``fused_stats`` (the kernels' twins here), validating each epoch."""
        cfg = tiny_cfg(num=2, ode_name=ode_name)
        out = experiment.run_experiment(
            cfg, synthetic=True, weights_root=str(tmp_path),
            results_file=str(tmp_path / "results_table"), padded_curriculum=True,
            fused_train=True, validate_each_epoch=True, device="cpu")
        assert out["trainer"].model.fused_stats
        assert len(out["history"]) == 8 and np.isfinite(out["history"][-1]["loss"])
        assert np.isfinite(out["history"][-1]["forecast_nll"])
        df = pd.read_csv(str(tmp_path / "results_table.csv"), index_col=0)
        assert np.isfinite(df[f"{cfg.test_season} {cfg.window_size + 6}"]).all()

    def test_fused_train_mode_stays_with_the_plain_path(self, tmp_path):
        out_plain = experiment.run_experiment(
            tiny_cfg(num=3), synthetic=True, weights_root=str(tmp_path / "a"), device="cpu")
        out_fused = experiment.run_experiment(
            tiny_cfg(num=3), synthetic=True, weights_root=str(tmp_path / "b"),
            fused_train=True, device="cpu")
        assert len(out_fused["history"]) == len(out_plain["history"])
        # the same seeds: first-epoch losses differ only by the order of float sums
        assert out_fused["history"][0]["loss"] == pytest.approx(
            out_plain["history"][0]["loss"], rel=1e-3)
        assert np.isfinite(out_fused["history"][-1]["loss"])

    def test_transfer_recipe(self, tmp_path):
        conn_cfg = tiny_cfg(ode_name="CONN", epochs=4)
        experiment.run_experiment(conn_cfg, synthetic=True, weights_root=str(tmp_path),
                                  device="cpu")
        trainer = experiment.run_transfer(
            tiny_cfg(ode_name="UONN", epochs=4, num=1),
            load_prefix=str(tmp_path / "weights" / conn_cfg.key), synthetic=True,
            weights_root=str(tmp_path), warm_epochs=1, ramp_epochs_each=0, final_epochs=1,
            n_samples=4, device="cpu")
        assert trainer.fa_w == pytest.approx(1.0)
        assert np.isfinite(trainer.history.epoch_history[-1]["loss"])

    def test_transfer_refuses_a_checkpoint_that_transfers_too_little(self, tmp_path):
        sonn = tiny_cfg(ode_name="SONN", epochs=4)
        experiment.run_experiment(sonn, synthetic=True, weights_root=str(tmp_path), device="cpu",
                                  curriculum=False)
        with pytest.raises(RuntimeError, match="Fp_net"):
            experiment.run_transfer(
                tiny_cfg(ode_name="UONN"), load_prefix=str(tmp_path / "weights" / sonn.key),
                synthetic=True, weights_root=str(tmp_path), device="cpu")


class TestAdaptiveCurriculum:
    def make(self, gamma, season_len, net):
        x_tr, y_tr, *_ = synthetic.synthetic_dataset(
            n_regions=1, n_qs=3, window_size=7, gamma=gamma, lag=5, run_backward=False,
            n_seasons=2, season_len=season_len, seed=0)
        model = UDEForecaster.build(
            n_regions=1, latent_dim=6, n_qs=3, ode_name="Fp", device="cpu",
            enc_params={"q_sizes": (12,), "ff_sizes": (8,)}, ode_params={"net_sizes": net})
        trainer = Trainer(model, loss_cfg=TRAINING_INFO["CONN"], len_tr=16)
        trainer.setup_training(lr=1e-3)
        return trainer, ArrayLoader(x_tr[:16], y_tr[:16], batch_size=16, seed=0)

    def test_tmax_grows_on_plateau(self):
        trainer, loader = self.make(28, 80, (8, 8))
        tmax = experiment.adaptive_curriculum_train(
            trainer, loader, gamma=28, epochs=3, tmax0=5, n_samples=4,
            nll_threshold=1e9, patience=1)      # always on the plateau: grows each epoch
        assert tmax == 7    # 5 + 2 (the first epoch has len(hist) <= patience)

    def test_lr_decays(self):
        trainer, loader = self.make(14, 60, (8,))
        experiment.adaptive_curriculum_train(trainer, loader, gamma=14, epochs=2, tmax0=3,
                                             n_samples=4, lr_decay=0.5, lr_floor=1e-5)
        assert trainer.opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.25)


# -- checkpoints crossing between the two packages ----------------------------------------------

def skip_training(monkeypatch, cls):
    monkeypatch.setattr(cls, "train", lambda self, *a, **k: None)
    monkeypatch.setattr(cls, "save", lambda self, *a, **k: None)


def test_jax_run_experiment_checkpoint_loads_through_port_run_transfer(tmp_path, monkeypatch):
    conn = jax_config.ExperimentConfig(**tiny_kw(epochs=4))
    jax_experiment.run_experiment(conn, synthetic=True, weights_root=str(tmp_path))
    prefix = os.path.join(str(tmp_path), "weights", conn.key)
    assert tiny_cfg(epochs=4).key == conn.key
    skip_training(monkeypatch, Trainer)
    tr = experiment.run_transfer(tiny_cfg(ode_name="UONN"), load_prefix=prefix, synthetic=True,
                                 weights_root=str(tmp_path), device="cpu")
    saved = load_flat(prefix)
    got = {}
    for part in ("enc", "ode", "dec"):
        got.update(flat_from_module(tr.model, part))
    assert set(saved) < set(got) and any(k.startswith(".fp_net") for k in saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    fresh = experiment.build_trainer(tiny_cfg(ode_name="UONN"), device="cpu").model
    for k, v in flat_from_module(fresh, "ode").items():        # aug_net keeps its own draw
        if k.startswith(".aug_net"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_run_experiment_checkpoint_loads_through_jax_run_transfer(tmp_path, monkeypatch):
    from fiude_tpu.train.checkpoint import tree_to_flat_dict
    conn = tiny_cfg(epochs=4)
    experiment.run_experiment(conn, synthetic=True, weights_root=str(tmp_path), device="cpu")
    prefix = os.path.join(str(tmp_path), "weights", conn.key)
    skip_training(monkeypatch, JaxTrainer)
    tr = jax_experiment.run_transfer(
        jax_config.ExperimentConfig(**tiny_kw(ode_name="UONN")), load_prefix=prefix,
        synthetic=True, weights_root=str(tmp_path))
    params = tr.state.params if tr.state is not None else tr.params
    got = {}
    for part in ("enc", "ode", "dec"):
        got.update(tree_to_flat_dict(getattr(params, part)))
    saved = load_flat(prefix)
    assert len(saved) == 16 and set(saved) < set(got)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    assert jax.tree.leaves(params.ode.aug_net)
