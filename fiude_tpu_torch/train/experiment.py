"""End-to-end experiment recipes (the reference's top layer).

Counterpart of ``fiude_tpu/train/experiment.py:36-233``:

* :func:`run_experiment`: one sweep unit with the growing-horizon curriculum
  (reference ``run_ode.py:120-170``): weekly eval grid, train
  ``epochs/(n_stages-1)`` epochs per stage on ``t[:eval_pts[-1]+1]``, save
  weights, evaluate into the results table.
* :func:`run_transfer`: the CONN -> UONN transfer recipe (reference
  ``testing_pre_train.py:132-146``): load trained CONN weights into a UONN,
  5 epochs at ``fa_w=0``, ramp fa_w 0 -> 1 in 0.1 steps (1 epoch each), then
  a long fine-tune.
* :func:`adaptive_curriculum_train`: the tuning harness's plateau-triggered
  horizon growth (reference ``tuning/tune_node.py:217-219``): extend tmax by
  one day whenever the last 10 epochs' NLL < -2.

Each entry point builds on the card unless the caller passes
``device="cpu"``, as :meth:`UDEForecaster.build` does.  Where the JAX
functions derive every random stream from ``seed`` through JAX's PRNG, here
``seed`` seeds the data, the loader's shuffle and the trainer's draws, and
the weights come from ``generator`` (a CPU ``torch.Generator``; seeded with
``seed + cfg.num`` when None).  The daily grid is built in float64: the port's
integrators take their steps from the grid in float64, so every step of a
uniform grid gets the same float32 ``dt`` (the JAX package builds it in
float32 and casts to the state's dtype, ``experiment.py:111``).

Real data: with a ``data_root`` (and not ``synthetic``) the recipes read
the reference's ``Data/`` tree through the port's ``DataConstructor``
(``run_backward=True, no_qs_in_output=True``, ``fill_1`` as given), as the
JAX package does; ``data.synthetic.write_reference_data_tree`` writes such a
tree.  The tuning worker and ``rerun_best`` wait for a later slice
(ROADMAP.md, queue A, item 4).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from fiude_tpu_torch.data.builder import DataConstructor
from fiude_tpu_torch.data.loader import ArrayLoader
from fiude_tpu_torch.data.synthetic import synthetic_dataset
from fiude_tpu_torch.models.vae import UDEForecaster
from fiude_tpu_torch.train import checkpoint as ckpt
from fiude_tpu_torch.train.losses import TRAINING_INFO
from fiude_tpu_torch.train.trainer import Trainer
from fiude_tpu_torch.utils.config import ExperimentConfig
from fiude_tpu_torch.utils.results import test_and_record


def _build_data(cfg: ExperimentConfig, data_root: Optional[str], synthetic: bool,
                fill_1: bool = False, seed: int = 0):
    if synthetic or data_root is None:
        # synthetic data has no real season calendar; shift the generator
        # seed by test_season so season columns in the results table are
        # independent replicates rather than duplicates of one draw
        season_shift = 7919 * (int(cfg.test_season) % 100)
        return synthetic_dataset(
            n_regions=cfg.n_regions, n_qs=cfg.n_qs,
            window_size=cfg.window_size, gamma=cfg.gamma,
            seed=seed + cfg.num + season_shift)
    dc = DataConstructor(test_season=cfg.test_season, region=cfg.region,
                         n_queries=cfg.n_qs, gamma=cfg.gamma,
                         window_size=cfg.window_size, fill_1=fill_1,
                         root=data_root)
    return dc(run_backward=True, no_qs_in_output=True)


def daily_grid(cfg: ExperimentConfig) -> np.ndarray:
    """The config's daily time grid in weeks, float64."""
    return np.arange(cfg.window_size + cfg.gamma + 1, dtype=np.float64) / 7.0


def build_trainer(cfg: ExperimentConfig, *, weights_root: str = ".", seed: int = 0,
                  fused_train: bool = False, device=None,
                  generator: Optional[torch.Generator] = None) -> Trainer:
    # fused_stats rides along with fused_train: the loss's aux epilogue
    # (kl_p moments, fa_norm) reduces in the kernels instead of streaming the
    # (4(T-1), B, *) aux tensors through device memory both ways
    if generator is None:
        generator = torch.Generator().manual_seed(seed + cfg.num)
    model = UDEForecaster.build(**cfg.model_kwargs(), fused_train=fused_train,
                                fused_stats=fused_train, generator=generator, device=device)
    return Trainer(
        model,
        loss_cfg=TRAINING_INFO[cfg.ode_name],
        len_tr=130,
        ode_kl_w=1 / 153 if cfg.ode_name.endswith("b") else None,
        file_prefix=os.path.join(weights_root, "weights", cfg.key),
        chkpt_prefix=os.path.join(weights_root, "chkpts", cfg.key),
        seed=seed + cfg.num,
    )


def run_experiment(cfg: ExperimentConfig, *,
                   data_root: Optional[str] = None,
                   synthetic: bool = False,
                   fill_1: bool = False,
                   weights_root: str = ".",
                   results_file: Optional[str] = None,
                   n_samples: Optional[int] = None,
                   validate_each_epoch: bool = False,
                   curriculum: bool = True,
                   padded_curriculum: bool = False,
                   pre_train_epochs: int = 0,
                   fused_train: bool = False,
                   verbose: bool = False,
                   seed: int = 0,
                   device=None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Train one config with the weekly growing-horizon curriculum and record
    results (reference run_ode.py:120-170).  ``pre_train_epochs`` enables the
    encoder-only KL warm-start used by the reference's testing.py
    (reference testing.py:135).

    ``padded_curriculum=True`` runs the masked curriculum
    (:meth:`Trainer.train_curriculum_padded`): every stage on the one weekly
    grid, with identical gradients.

    ``fused_train=True`` trains through the hand-written kernels (K3/K4 and
    K5/K6 in stats mode, K8/K9 for a Bayes family) instead of the plain
    modules; on the card nothing falls back."""
    n_samples = n_samples or cfg.n_samples
    x_tr, y_tr, x_te, y_te, scaler = _build_data(cfg, data_root, synthetic, fill_1, seed)
    loader = ArrayLoader(x_tr, y_tr, batch_size=cfg.batch_size, seed=seed)

    t = daily_grid(cfg)
    trainer = build_trainer(cfg, weights_root=weights_root, seed=seed,
                            fused_train=fused_train, device=device, generator=generator)
    trainer.setup_training(lr=cfg.lr)
    if pre_train_epochs:
        trainer.pre_train(loader, epochs=pre_train_epochs, lr=cfg.lr)

    validate = None
    if validate_each_epoch:
        validate = {"x_test": x_te, "y_test": y_te[:, : len(t)], "t": t,
                    "scaler": np.asarray(scaler), "n_samples": 32}

    # weekly growing-horizon curriculum (run_ode.py:147-164)
    eval_all = list(np.linspace(0, cfg.gamma, int(cfg.gamma / 7) + 1, dtype=int))
    stages = range(2, len(eval_all) + 1) if curriculum else [len(eval_all)]
    # clamp to >= 1 so tiny epoch budgets still train each stage; the
    # reference never hits this (its sweeps use epochs >= 140, run_ode.py:149)
    epochs_per_cycle = (max(int(cfg.epochs / (len(eval_all) - 1)), 1)
                        if curriculum else cfg.epochs)
    norm_file = os.path.join(weights_root, "norms", cfg.key + "norms.txt")
    if padded_curriculum and curriculum:
        trainer.train_curriculum_padded(
            loader, t, np.asarray(eval_all), epochs_per_cycle,
            n_samples=n_samples, grad_lim=cfg.grad_lim, checkpoint=True,
            validate=validate, verbose=verbose, norm_file=norm_file)
    else:
        for i in stages:
            eval_pts = eval_all[:i]
            time_steps = t[: eval_pts[-1] + 1]
            trainer.train(loader, time_steps, epochs_per_cycle,
                          eval_pts, n_samples=n_samples,
                          grad_lim=cfg.grad_lim, checkpoint=True,
                          validate=validate, verbose=verbose,
                          norm_file=norm_file)

    trainer.save()
    values: Dict[str, Any] = {}
    if results_file is not None:
        values = test_and_record(
            trainer, np.asarray(scaler), x_te, y_te[:, : len(t)], t,
            test_season=cfg.test_season, window_size=cfg.window_size,
            variables={"epochs": cfg.epochs, "gamma": cfg.gamma,
                       "ode_name": cfg.ode_name, "region": cfg.region,
                       "latent_dim": cfg.latent_dim,
                       "window_size": cfg.window_size, "num": cfg.num},
            n_samples=128, file_name=results_file)
    return {"trainer": trainer, "metrics": values,
            "history": trainer.history.epoch_history}


def transferable_keys(model: UDEForecaster) -> list:
    """The parameters a deterministic CONN checkpoint must give ``model``: the
    encoder's, the decoder's and, unless ``model`` is a Bayes family (whose
    keys differ), ``Fp_net``'s."""
    keys = [key for part in ("enc", "dec") for key, _, _ in ckpt.param_map(model, part)]
    if not model.is_bayes:
        keys += [key for key, _, _ in ckpt.param_map(model, "ode") if key.startswith(".fp_net")]
    return keys


def run_transfer(cfg: ExperimentConfig, *,
                 load_prefix: str,
                 data_root: Optional[str] = None,
                 synthetic: bool = False,
                 weights_root: str = ".",
                 ramp_epochs_each: int = 1,
                 warm_epochs: int = 5,
                 final_epochs: int = 100,
                 n_samples: Optional[int] = None,
                 grad_lim: float = 1500.0,
                 verbose: bool = False,
                 fused_train: bool = False,
                 seed: int = 0,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> Trainer:
    """CONN -> UONN transfer (reference testing_pre_train.py:132-146):
    load, train at fa_w=0, ramp 0 -> 1 by 0.1/epoch, long fine-tune.

    The load merges by key and shape, which transfers the rates net only
    because it is named ``Fp_net`` in UONN as in CONN; a checkpoint that leaves
    any parameter of the model's encoder, ``Fp_net`` or decoder uncopied
    raises.  ``fused_train`` composes with the ramp: the kernels take ``fa_w``
    at run time."""
    assert cfg.ode_name in ("UONN", "FaFp", "UONNb"), "transfer targets a UDE"
    n_samples = n_samples or cfg.n_samples
    x_tr, y_tr, *_ = _build_data(cfg, data_root, synthetic, seed=seed)
    loader = ArrayLoader(x_tr, y_tr, batch_size=cfg.batch_size, seed=seed)

    t = daily_grid(cfg)
    eval_pts = np.arange(0, t.shape[-1], 7)

    trainer = build_trainer(cfg, weights_root=weights_root, seed=seed,
                            fused_train=fused_train, device=device, generator=generator)
    trainer.setup_training(lr=cfg.lr)
    missing = set(transferable_keys(trainer.model)) - set(trainer.load(file_prefix=load_prefix))
    if missing:
        raise RuntimeError(f"the checkpoint {load_prefix!r} does not give the model its encoder, "
                           f"Fp_net and decoder: nothing copied for {sorted(missing)}")

    trainer.fa_w = 0.0
    for _ in range(warm_epochs):
        trainer.train(loader, t, 1, eval_pts, n_samples=n_samples,
                      grad_lim=grad_lim, checkpoint=True, verbose=verbose)
    for _ in range(10):
        trainer.fa_w = round(trainer.fa_w + 0.1, 10)
        trainer.train(loader, t, ramp_epochs_each, eval_pts,
                      n_samples=n_samples, grad_lim=grad_lim,
                      checkpoint=True, verbose=verbose)
    trainer.train(loader, t, final_epochs, eval_pts, n_samples=n_samples,
                  grad_lim=grad_lim, checkpoint=True, verbose=verbose)
    trainer.save()
    return trainer


def adaptive_curriculum_train(trainer: Trainer, loader, *, gamma: int,
                              epochs: int, tmax0: int = 10,
                              tmax_cap: int = 28, n_samples: int = 32,
                              grad_lim: float = 5000.0,
                              nll_threshold: float = -2.0,
                              patience: int = 10,
                              lr_decay: float = 0.999,
                              lr_floor: float = 1e-4) -> int:
    """Plateau-triggered horizon growth (reference tune_node.py:190-221):
    each epoch trains on a daily grid of length ``tmax``; when the last
    ``patience`` epochs all have NLL below ``nll_threshold``, tmax += 1.
    Returns the final tmax."""
    tmax = tmax0
    for _ in range(epochs):
        t = np.linspace(1.0, tmax, tmax) / 7.0
        eval_pts = np.arange(tmax)
        trainer.train(loader, t, 1, eval_pts, n_samples=n_samples,
                      grad_lim=grad_lim)
        hist = trainer.history.epoch_history
        if len(hist) > patience and all(
                h["nll"] < nll_threshold for h in hist[-patience:]):
            tmax = min(tmax + 1, tmax_cap)
        trainer.decay_lr(lr_decay, lr_floor)
    return tmax
