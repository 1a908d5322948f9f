"""Bayes-UDE development workflow (counterpart of ``scripts/bayes_workflow.py``,
the script form of the reference's ``run_ode.ipynb`` cells 0-11): build
data, train a variational-weight ``Bayes_FaFp`` (UONNb) with a custom loss
gate set, change the weight-prior std halfway (cell 8,
``lib/VAE.py:103-110``: :meth:`Trainer.update_priors`), then write the
notebook's diagnostics.

Where the JAX script draws a figure, this one writes the data behind it
(the card's machine has no matplotlib):

* ``curves.json``: the epoch history (loss, nll, ode_kl, ...; cell 9) and
  the epoch after which the prior changed;
* ``fan_charts.npz``: the 64-sample test forecast's ``mean`` and ``std``
  (numpy's, ddof 0) and the ``truth``, (windows, T, R), with the
  ``eval_pts`` the JAX script plots (cells 10-11);
* ``rate_posterior.npz``: the stage-ordered ``rates`` aux of a 32-sample test
  forward, flattened to (N, 2) (beta, gamma), beside the rate prior
  ``prior_mean`` (0.8, 0.55) and ``prior_std`` (0.2, 0.2).

It trains and forecasts on the plain path, as the JAX script does.

    python -m fiude_tpu_torch.scripts.bayes_workflow --epochs 30 --out-dir bayes_out \\
        [--device cpu]
"""
import argparse
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from fiude_tpu_torch.data.loader import ArrayLoader
from fiude_tpu_torch.data.synthetic import synthetic_dataset
from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.models.vae import resolve_device
from fiude_tpu_torch.train.losses import LossConfig
from fiude_tpu_torch.train.trainer import Trainer

#: the rate prior the posterior is drawn beside (means, stds of beta, gamma)
RATE_PRIOR = ((0.8, 0.55), (0.2, 0.2))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="bayes_out")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n-samples", type=int, default=16)
    ap.add_argument("--window", type=int, default=14)
    ap.add_argument("--gamma", type=int, default=28)
    ap.add_argument("--prior-std", type=float, default=0.05)
    ap.add_argument("--new-prior-std", type=float, default=0.1,
                    help="prior std applied mid-run (notebook cell 8)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (the card when omitted; `cpu` runs the plain path there)")
    return ap


def prepare(args, device, **model_kw) -> Dict[str, Any]:
    """The data (cell 5; synthetic in place of the reference's ``Data/``), the
    ``Bayes_FaFp`` model at the script's widths (cells 4/6) and its trainer
    with the custom loss gates (cell 7: nll, kl_z, fa_norm 0.1, reg_loss,
    anneal; no kl_p), set up; ``model_kw`` goes to ``UDEForecaster.build``."""
    x_tr, y_tr, x_te, y_te, _ = synthetic_dataset(
        n_regions=1, n_qs=5, window_size=args.window, gamma=args.gamma, seed=args.seed)
    model = UDEForecaster.build(
        n_regions=1, latent_dim=8, n_qs=5, ode_name="Bayes_FaFp",
        enc_params={"q_sizes": (64, 32), "ff_sizes": (32, 32),
                    "SIR_scaler": [0.1, 0.05, 1.0]},
        ode_params={"net_sizes": (32, 32, 16), "aug_net_sizes": (32, 32),
                    "prior_std": args.prior_std},
        generator=torch.Generator().manual_seed(args.seed), device=device, **model_kw)
    loss_cfg = LossConfig(nll=True, mse=False, kl_z=True, kl_p=False, fa_norm=0.1,
                          reg_loss=True, anneal=True)
    trainer = Trainer(model, loss_cfg=loss_cfg, len_tr=len(x_tr), ode_kl_w=1 / 153,
                      seed=args.seed, file_prefix=os.path.join(args.out_dir, "bayes_"))
    trainer.setup_training(lr=1e-3)
    t = np.arange(args.window + args.gamma + 1, dtype=np.float64) / 7.0
    return {"trainer": trainer, "loader": ArrayLoader(x_tr, y_tr, batch_size=32, seed=args.seed),
            "x_test": x_te, "y_test": y_te, "t": t, "eval_pts": np.arange(0, len(t), 7),
            "half": max(args.epochs // 2, 1)}


def train_halves(run: Dict[str, Any], args) -> None:
    """Half the epochs, ``update_priors(--new-prior-std)`` (cell 8), the rest."""
    trainer, kw = run["trainer"], dict(n_samples=args.n_samples, grad_lim=1e5, verbose=True)
    trainer.train(run["loader"], run["t"], run["half"], run["eval_pts"], **kw)
    trainer.update_priors(args.new_prior_std)
    trainer.train(run["loader"], run["t"], args.epochs - run["half"], run["eval_pts"], **kw)


def write_diagnostics(run: Dict[str, Any], args) -> None:
    """``curves.json``, ``fan_charts.npz`` and ``rate_posterior.npz``."""
    trainer, model = run["trainer"], run["trainer"].model
    with open(os.path.join(args.out_dir, "curves.json"), "w") as fh:
        json.dump({"epochs": trainer.history.epoch_history, "update_priors_after": run["half"],
                   "prior_std": args.prior_std, "new_prior_std": args.new_prior_std}, fh,
                  indent=1)

    y_pred = trainer.forecast(run["x_test"], run["t"], n_samples=64).cpu().numpy()
    np.savez(os.path.join(args.out_dir, "fan_charts.npz"), mean=y_pred.mean(1),
             std=y_pred.std(1), truth=np.asarray(run["y_test"]), eval_pts=run["eval_pts"])

    gen = torch.Generator(device=trainer.device).manual_seed(args.seed + 1)
    x = trainer._tensor(run["x_test"])
    eps = model.sample_eps(x.shape[0], 32, generator=gen, dtype=trainer.dtype)
    with torch.no_grad():
        _, extras = model(x, run["t"], eps, noise_seed=args.seed + 2)
    np.savez(os.path.join(args.out_dir, "rate_posterior.npz"),
             rates=extras.aux["rates"].cpu().numpy().reshape(-1, 2),
             prior_mean=np.asarray(RATE_PRIOR[0]), prior_std=np.asarray(RATE_PRIOR[1]))


def main(argv=None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    run = prepare(args, device)
    train_halves(run, args)
    run["trainer"].save()
    write_diagnostics(run, args)
    print("wrote", args.out_dir, ":", sorted(os.listdir(args.out_dir)))
    return run


if __name__ == "__main__":
    main()
