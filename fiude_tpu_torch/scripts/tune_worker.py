"""Hyperparameter-tuning work-queue worker (reference ``tuning/tune_node.py``;
counterpart of ``scripts/tune_worker.py``).

Claims rows from a ``validation_scores.csv`` grid (columns = hyperparameters
+ ``started`` + ``score``), trains a model with the adaptive curriculum, and
writes the validation NLL back, stamping ``platform`` with the torch device
type.  Launch many instances: coordination is the file-locked CSV, shared with
the JAX package's workers.  Create a grid first with
``python -m fiude_tpu_torch.scripts.make_tuning_grid``.
"""
import argparse

import numpy as np
import torch

from fiude_tpu_torch.data.loader import ArrayLoader
from fiude_tpu_torch.data.synthetic import synthetic_dataset
from fiude_tpu_torch.models.vae import UDEForecaster, resolve_device
from fiude_tpu_torch.train.experiment import adaptive_curriculum_train, run_tuning_worker
from fiude_tpu_torch.train.losses import TRAINING_INFO, nll_loss
from fiude_tpu_torch.train.trainer import Trainer

#: The tuning harness's un-scaling of its synthetic targets (tune_node.py).
TARGET_SCALE = 7.7151


def tuning_run(params: dict, device, seed: int = 0):
    """One tuning evaluation's training (reference tune_node.py:123-232):
    encoder pre-train, adaptive-curriculum training, then a forecast of the
    test windows.  ``seed`` seeds the weights, the trainer and the loader.
    Returns ``(tmax, forecast (B, S, tmax, R), truth (B, tmax, R))``, both
    un-scaled."""
    latent_dim = int(params["latent_dim"])
    n_qs = int(params.get("n_qs", params.get("input_size", 10)) or 10)
    window_size = int(params["window_size"])
    batch_size = int(params["batch_size"])
    n_samples = int(params["n_samples"])
    epochs = int(params["epochs"])
    hidden = int(params.get("hidden_size", 64))
    gamma = 56

    x_tr, y_tr, x_te, y_te, _ = synthetic_dataset(
        n_regions=1, n_qs=n_qs, window_size=window_size, gamma=gamma,
        run_backward=False, seed=0)
    model = UDEForecaster.build(
        n_regions=1, latent_dim=latent_dim, n_qs=n_qs, ode_name="Fp",
        enc_params={"q_sizes": (hidden,), "ff_sizes": (hidden // 2,)},
        ode_params={"net_sizes": (32, 32)}, device=device,
        generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(model, loss_cfg=TRAINING_INFO["CONN"],
                      len_tr=max(len(x_tr) // batch_size, 1), seed=seed)
    trainer.setup_training(lr=1e-3)
    loader = ArrayLoader(x_tr, y_tr, batch_size=batch_size, seed=seed)
    trainer.pre_train(loader, epochs=30)
    tmax = adaptive_curriculum_train(trainer, loader, gamma=gamma, epochs=epochs,
                                     tmax0=min(gamma, 10), tmax_cap=28, n_samples=n_samples)
    t = np.linspace(1.0, tmax, tmax) / 7.0
    y_pred = trainer.forecast(x_te, t, n_samples=n_samples)
    truth = trainer._tensor(y_te[:, :tmax, :])
    return tmax, y_pred * TARGET_SCALE, truth * TARGET_SCALE


def evaluate(params: dict, device) -> float:
    """One tuning evaluation: the test-set NLL of :func:`tuning_run`."""
    _, pred, truth = tuning_run(params, device)
    return float(nll_loss(pred, truth))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("worker_id", type=int, nargs="?", default=0)
    ap.add_argument("--csv", default="validation_scores.csv")
    ap.add_argument("--max-rows", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (the card when omitted); rows are stamped with its "
                         "type in a 'platform' provenance column")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = run_tuning_worker(args.csv, lambda params: evaluate(params, device),
                          max_rows=args.max_rows, extra_cols={"platform": device.type})
    print(f"worker {args.worker_id}: processed {n} rows")


if __name__ == "__main__":
    main()
