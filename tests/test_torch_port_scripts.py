"""The port's demo and Bayes-workflow commands and ``Trainer.update_priors``,
on the CPU:

* ``fiude_tpu_torch.scripts.demo_accuracy.main`` at 1 epoch (the UONN row)
  and ``bayes_workflow.main`` at 2 epochs run and write their files with the
  JAX scripts' keys (the figures' data in place of the figures), on a shorter
  synthetic series (2 seasons of 80 days) to keep them to seconds;
* ``update_priors`` changes ``ode_kl`` exactly as the JAX ``update_priors``
  does on tied weights (float64, rel 1e-12), on the lone step and on the
  device-resident epoch;
* without a card and without ``--device cpu`` both commands raise before they
  touch a file.
"""
import functools
import json
import os

import numpy as np
import pytest

import jax
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.models.bayes import variational_kl as jax_variational_kl
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train import Trainer as JaxTrainer
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.data import ArrayLoader
from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.scripts import bayes_workflow, demo_accuracy
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, experiment, load_state_from_flat
from fiude_tpu_torch.utils.config import REGION_INFO

torch.set_num_threads(1)

R, L = 3, 6
CONFIG = dict(n_regions=R, latent_dim=L, n_qs=3,
              enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
              ode_params={"net_sizes": (10, 10), "aug_net_sizes": (8,), "prior_std": 0.05})
DEMO_KEYS = ["model", "first_epoch_nll", "final_epoch_nll", "final_loss", "minutes",
             "2016 34", "skill 2016 7", "2016 41", "skill 2016 14", "2016 48", "skill 2016 21",
             "2016 55", "skill 2016 28"]


def short_series(monkeypatch, module):
    monkeypatch.setattr(module, "synthetic_dataset", functools.partial(
        module.synthetic_dataset, n_seasons=2, season_len=80))


def test_demo_accuracy_runs_and_writes_its_files(tmp_path, monkeypatch):
    monkeypatch.setitem(REGION_INFO, "demo", None)           # main registers the preset
    short_series(monkeypatch, experiment)
    out = str(tmp_path / "demo")
    rows = demo_accuracy.main(["--out-dir", out, "--epochs", "1", "--models", "UONN",
                               "--device", "cpu"])
    assert REGION_INFO["demo"]["enc_params"]["q_sizes"] == (128, 64)
    assert {"summary.json", "RESULTS_SYNTH.md", "demo_results.csv"} <= set(os.listdir(out))
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)
    assert summary == rows and list(rows[0]) == DEMO_KEYS and rows[0]["model"] == "UONN"
    assert all(np.isfinite(v) for k, v in rows[0].items() if k != "model")
    text = open(os.path.join(out, "RESULTS_SYNTH.md")).read()
    assert text.startswith("# Synthetic-data accuracy demonstration") and "## UONN" in text


def test_bayes_workflow_runs_and_writes_its_files(tmp_path, monkeypatch):
    short_series(monkeypatch, bayes_workflow)
    out = str(tmp_path / "bayes")
    run = bayes_workflow.main(["--out-dir", out, "--epochs", "2", "--device", "cpu"])
    trainer = run["trainer"]
    assert trainer.model.is_bayes and trainer.model.ode.prior_std == 0.1   # after the change
    assert trainer.loss_cfg.ode_kl_w == 1 / 153 and not trainer.loss_cfg.kl_p
    assert {"bayes_enc.npz", "bayes_ode.npz", "bayes_dec.npz", "curves.json",
            "fan_charts.npz", "rate_posterior.npz"} <= set(os.listdir(out))
    with open(os.path.join(out, "curves.json")) as fh:
        curves = json.load(fh)
    assert len(curves["epochs"]) == 2 and curves["update_priors_after"] == 1
    assert {"loss", "nll", "ode_kl"} <= set(curves["epochs"][0])
    fan = np.load(os.path.join(out, "fan_charts.npz"))
    n_test, T = len(run["x_test"]), len(run["t"])
    assert fan["mean"].shape == fan["std"].shape == fan["truth"].shape == (n_test, T, 1)
    assert list(fan["eval_pts"]) == list(range(0, T, 7))
    post = np.load(os.path.join(out, "rate_posterior.npz"))
    assert post["rates"].shape == (n_test * 32 * (T - 1) * 4, 2)
    assert np.isfinite(post["rates"]).all()
    assert list(post["prior_mean"]) == [0.8, 0.55] and list(post["prior_std"]) == [0.2, 0.2]


def tied_pair():
    jm = JaxForecaster.build(ode_name="UONNb", dtype="float64", **CONFIG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5))
    jt = JaxTrainer(model=jm, loss_cfg=JAX_INFO["UONNb"], seed=7, len_tr=10, ode_kl_w=1 / 153)
    jt.params = params                 # no optimizer: update_priors then compiles nothing
    port = UDEForecaster.build(device="cpu", ode_name="UONNb", dtype=torch.float64, **CONFIG)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    pt = Trainer(model=port, loss_cfg=TRAINING_INFO["UONNb"], seed=7, len_tr=10,
                 ode_kl_w=1 / 153)
    pt.setup_training(lr=1e-3)
    return jt, pt


def jax_ode_kl(jt):
    kl = jax.jit(jax_variational_kl, static_argnums=1)(jt.params.ode, jt.model.ode.prior_std)
    return float(kl) / 153


def batch(port, n=4, T=4):
    rng = np.random.default_rng(9)
    return (rng.uniform(0, 1, (n, 10, port.encoder.input_size)), rng.uniform(0, 1, (n, T, R)),
            np.arange(T) / 7.0)


def test_update_priors_changes_ode_kl_as_jax_on_the_lone_step():
    jt, pt = tied_pair()
    assert Trainer.update_priors is Trainer.set_prior_std
    x, y, t = batch(pt.model)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    before = jax_ode_kl(jt)
    jt.update_priors(0.3)
    pt.update_priors(0.3)
    after = jax_ode_kl(jt)
    assert jt.model.ode.prior_std == pt.model.ode.prior_std == 0.3 and after != before
    got = pt.train_step(x, y, t, epoch=1, grad_lim=1e9, n_samples=3)["ode_kl"]
    assert got == pytest.approx(after, rel=1e-12)


def test_update_priors_changes_ode_kl_as_jax_on_the_epoch():
    jt, pt = tied_pair()
    x, y, t = batch(pt.model, n=6)
    jt.update_priors(0.02)
    pt.update_priors(0.02)
    pt.train(ArrayLoader(x, y, batch_size=4, seed=0), t, 1, np.arange(len(t)), n_samples=3,
             grad_lim=1e9)
    first = pt.history.batch_history[-1][0]
    assert len(pt.history.batch_history[-1]) == 2           # a full batch and the tail
    assert first["ode_kl"] == pytest.approx(jax_ode_kl(jt), rel=1e-12)


@pytest.mark.parametrize("script", [demo_accuracy, bayes_workflow])
def test_the_cpu_only_when_asked_for(script, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["--out-dir", str(out), "--epochs", "1"])
    assert not out.exists()
