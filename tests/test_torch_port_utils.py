"""The port's leftover utilities against the JAX package's, on the CPU:

* ``utils/latent_ode.py`` against ``fiude_tpu.utils.latent_ode`` with the
  same ``numpy.random.Generator`` seeds, on the cases of
  ``tests/test_latent_ode_utils.py``: equal arrays, equal dicts;
* ``utils/logging.py::get_logger``;
* the table forms of ``nll`` / ``mae`` / ``mb_log`` / ``skill`` (a
  ``tables.Frame`` and a plain mapping) against ``fiude_tpu.utils.metrics``
  on a pandas frame of the same arrays, and the binned forms on a CDC table
  read from one CSV, bit for bit;
* ``nll_torch`` / ``mb_log_torch`` / ``skill_torch`` against the ``*_jnp``
  forms in float64 at rtol 1e-12.
"""
import logging

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from fiude_tpu.utils import latent_ode as jax_lo
from fiude_tpu.utils import metrics as jax_metrics

from fiude_tpu_torch.data.tables import Frame, read_frame
from fiude_tpu_torch.utils import latent_ode, metrics
from fiude_tpu_torch.utils.logging import get_logger

torch.set_num_threads(1)


def batch(n=4, T=30, F=3, seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(n, T, F)) > 0.2).astype(np.float32)
    mask[:, :, 0] = 1.0
    return {"data": rng.uniform(size=(n, T, F)).astype(np.float32),
            "time_steps": np.arange(T, dtype=np.float32), "mask": mask,
            "labels": (rng.uniform(size=(n, 2)) > 0.5).astype(np.float64)}


def assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b


def test_latent_ode_exports_the_same_names():
    assert latent_ode.__all__ == jax_lo.__all__


@pytest.mark.parametrize("n_tp", [None, 10, 0.5])
def test_subsample_timepoints_equals_jax(n_tp):
    d = batch(T=40)
    args = (d["data"], d["time_steps"], d["mask"], n_tp)
    assert_same(latent_ode.subsample_timepoints(*args, rng=np.random.default_rng(1)),
                jax_lo.subsample_timepoints(*args, rng=np.random.default_rng(1)))


@pytest.mark.parametrize("n_cut", [None, 6])
def test_cut_out_timepoints_equals_jax(n_cut):
    d = batch()
    args = (d["data"], d["time_steps"], d["mask"], n_cut)
    assert_same(latent_ode.cut_out_timepoints(*args, rng=np.random.default_rng(3)),
                jax_lo.cut_out_timepoints(*args, rng=np.random.default_rng(3)))


@pytest.mark.parametrize("kw", [dict(extrap=True), dict(extrap=False, sample_tp=12),
                                dict(extrap=True, cut_tp=3, sample_tp=0.5)])
def test_splits_equal_jax(kw):
    d = batch(T=40)
    assert_same(latent_ode.split_data_extrap(d), jax_lo.split_data_extrap(d))
    assert_same(latent_ode.split_data_interp(d), jax_lo.split_data_interp(d))
    assert_same(latent_ode.split_and_subsample_batch(d, rng=np.random.default_rng(4), **kw),
                jax_lo.split_and_subsample_batch(d, rng=np.random.default_rng(4), **kw))


def test_classification_metrics_equal_jax():
    rng = np.random.default_rng(5)
    labels = (rng.uniform(size=500) > 0.7).astype(np.float64)
    scores = labels * 0.3 + rng.normal(size=500)
    scores[:50] = scores[0]                                   # ties
    assert latent_ode.roc_auc(labels, scores) == jax_lo.roc_auc(labels, scores)
    onehot = np.eye(4)[rng.integers(0, 4, size=(3, 5))]
    onehot[0, 1] = 0.0                                        # an unlabeled point
    preds = rng.normal(size=(3, 5, 4))
    assert latent_ode.onehot_accuracy(onehot, preds) == jax_lo.onehot_accuracy(onehot, preds)
    with pytest.raises(ValueError):
        latent_ode.roc_auc(np.ones(4), np.arange(4.0))


@pytest.mark.parametrize("mode", ["binary", "onehot"])
def test_compute_loss_all_batches_equals_jax(mode):
    def run(fn):
        rng = np.random.default_rng(6)
        if mode == "binary":
            batches = [{"labels": (rng.uniform(size=(8, 1)) > 0.5).astype(np.float64)}
                       for _ in range(3)]
        else:
            batches = [{"labels": np.eye(3)[rng.integers(0, 3, size=4)]} for _ in range(3)]
        noise = np.random.default_rng(7)

        def losses(b):
            preds = np.broadcast_to(b["labels"], (2,) + b["labels"].shape)
            return {"loss": noise.uniform(), "mse": np.float32(noise.uniform()),
                    "label_predictions": preds + noise.normal(scale=0.3, size=preds.shape)}

        return fn(losses, batches, classif=True, classif_mode=mode, max_batches=2)

    assert_same(run(latent_ode.compute_loss_all_batches), run(jax_lo.compute_loss_all_batches))


def test_get_logger(tmp_path):
    path = str(tmp_path / "logs" / "run.log")
    log = get_logger(path, displaying=True, saving=True, debug=True)
    assert log.level == logging.DEBUG and len(log.handlers) == 2
    log.info("hello from the port")
    for h in log.handlers:
        h.flush()
    assert "hello from the port" in open(path).read()
    again = get_logger(path, displaying=False, saving=False)
    assert again is log and again.handlers == [] and again.level == logging.INFO


# -- metrics ---------------------------------------------------------------------------

def forecast(n=200, seed=2):
    rng = np.random.default_rng(seed)
    true = rng.uniform(0, 6, n)
    pred = true + rng.normal(0, 0.8, n)
    std = rng.uniform(0.05, 1.5, n)
    std[:3] = 1e-4                                     # cdf differences of exactly 0: the floor
    return true, pred, std


@pytest.mark.parametrize("form", ["frame", "mapping"])
@pytest.mark.parametrize("name", ["nll", "mae", "mb_log", "skill"])
def test_table_forms_equal_jax(name, form):
    true, pred, std = forecast()
    true = true.copy()
    if name == "mae":
        true[7] = np.nan                               # pandas' mean skips it
    cols = {"True": true, "Pred": pred, "Std": std}
    table = (Frame(np.arange(len(true)), tuple(cols), np.column_stack(list(cols.values())))
             if form == "frame" else cols)
    want = getattr(jax_metrics, name)(pd.DataFrame(cols))
    got = getattr(metrics, name)(table)
    assert np.array_equal(got, want)
    if name != "mae":                                   # the array form is the same function
        assert np.array_equal(getattr(metrics, name)(true, pred, std), want)


def cdc_table(path, rows=30, seed=8):
    """A CDC binned table: bins 0.0 .. 13.0 by 0.1 and a ``True`` column."""
    rng = np.random.default_rng(seed)
    edges = [f"{e / 10:.1f}" for e in range(131)]
    probs = rng.dirichlet(np.full(131, 0.3), size=rows)
    frame = pd.DataFrame(probs, columns=edges)
    frame["True"] = np.round(rng.uniform(0.0, 12.5, rows), 3)
    frame.to_csv(path)


@pytest.mark.parametrize("name", ["mb_log", "skill"])
def test_binned_forms_equal_jax(tmp_path, name):
    path = str(tmp_path / "cdc.csv")
    cdc_table(path)
    want = getattr(jax_metrics, name)(pd.read_csv(path, index_col=0), bins=True)
    got = getattr(metrics, name)(read_frame(path, parse_dates=False), bins=True)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["nll", "mb_log", "skill"])
def test_torch_forms_equal_the_jnp_forms(name):
    true, pred, std = forecast(seed=3)        # tails down to 1e-46 and cdf differences of 0
    want = np.asarray(getattr(jax_metrics, f"{name}_jnp")(
        jnp.asarray(true), jnp.asarray(pred), jnp.asarray(std)))
    got = getattr(metrics, f"{name}_torch")(*(torch.from_numpy(a) for a in (true, pred, std)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    if name != "nll":
        host = getattr(metrics, name)(true, pred, std)
        np.testing.assert_allclose(got.numpy(), host, rtol=1e-12, atol=0)


def test_the_floor_holds_on_the_device_form():
    got = metrics.mb_log_torch(torch.tensor([0.0]), torch.tensor([50.0]), torch.tensor([0.01]))
    assert got.item() == pytest.approx(np.log(4.5399929762484854e-05), rel=1e-6)
