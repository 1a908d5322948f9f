"""Encoder-architecture comparison workers (counterpart of
``scripts/tune_encoders.py``; reference ``tuning/tune_encoders.py``, which
compared the BiGRU, MISO-GRU and Back-GRU encoders over a file-locked CSV
queue).

Grid CSV columns: encoder (back_gru|bigru|bilstm), latent_dim, hidden_size,
window_size, batch_size, n_samples, epochs, started, score.  Write the grid
with ``--make-grid`` (the bytes the JAX script's pandas writes), then run any
number of workers on it, each on the card unless ``--device`` names another
device; they share the table with the JAX package's workers (the same lock).

    python -m fiude_tpu_torch.scripts.tune_encoders --make-grid --csv scores.csv
    python -m fiude_tpu_torch.scripts.tune_encoders 0 --csv scores.csv

Each row trains a CONN model (``Fp``, rates net (32, 32)) with that encoder
on the synthetic single-region series: the Back-GRU encoder is pre-trained
first (KL_z, 5 epochs), then ``epochs`` epochs of ``Trainer.train`` over the
28 daily points, and the score is the test windows' NLL.  A row's line gives
its seconds.
"""
import argparse
import itertools
import time

import numpy as np
import torch

from fiude_tpu_torch.data.loader import ArrayLoader
from fiude_tpu_torch.data.synthetic import synthetic_dataset
from fiude_tpu_torch.models.vae import UDEForecaster, resolve_device
from fiude_tpu_torch.train.experiment import run_tuning_worker
from fiude_tpu_torch.train.losses import TRAINING_INFO, nll_loss
from fiude_tpu_torch.train.trainer import Trainer
from fiude_tpu_torch.utils.results import atomic_write_table

N_QS, GAMMA = 8, 28
COLUMNS = ["encoder", "latent_dim", "hidden_size", "window_size", "batch_size", "n_samples",
           "epochs", "started", "score"]


def enc_params(encoder: str, hidden: int) -> dict:
    """Each family's widths from the grid's ``hidden_size``
    (``scripts/tune_encoders.py:41-46``)."""
    return {"back_gru": {"q_sizes": (hidden,), "ff_sizes": (hidden // 2,)},
            "bigru": {"q_sizes": (hidden,), "ili_sizes": (hidden // 2,),
                      "ff_sizes": (hidden // 2,)},
            "bilstm": {"hidden_size": hidden}}[encoder]


def setup(params: dict, device, seed: int = 0):
    """One row's data, trainer and loader (``scripts/tune_encoders.py:
    18-56``): ``(trainer, loader, (x_te, y_te))``; ``seed`` seeds the weights,
    the trainer and the loader."""
    encoder = str(params.get("encoder", "back_gru"))
    batch_size = int(params["batch_size"])
    x_tr, y_tr, x_te, y_te, _ = synthetic_dataset(
        n_regions=1, n_qs=N_QS, window_size=int(params["window_size"]), gamma=GAMMA,
        run_backward=False, seed=0)
    model = UDEForecaster.build(
        n_regions=1, latent_dim=int(params["latent_dim"]), n_qs=N_QS, ode_name="Fp",
        encoder_name=encoder, enc_params=enc_params(encoder, int(params.get("hidden_size", 64))),
        ode_params={"net_sizes": (32, 32)}, device=device,
        generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(model, loss_cfg=TRAINING_INFO["CONN"],
                      len_tr=max(len(x_tr) // batch_size, 1), seed=seed)
    trainer.setup_training(lr=1e-3)
    return trainer, ArrayLoader(x_tr, y_tr, batch_size=batch_size, seed=seed), (x_te, y_te)


def evaluate(params: dict, device) -> float:
    """One row: pre-train a Back-GRU encoder (the live encoder's KL
    pre-training), train, forecast the test windows; their NLL."""
    trainer, loader, (x_te, y_te) = setup(params, device)
    n_samples = int(params["n_samples"])
    if params.get("encoder", "back_gru") == "back_gru":
        trainer.pre_train(loader, epochs=5)
    t = np.linspace(1.0, GAMMA, GAMMA) / 7.0
    trainer.train(loader, t, int(params["epochs"]), np.arange(GAMMA), n_samples=n_samples,
                  grad_lim=5000)
    y_pred = trainer.forecast(x_te, t, n_samples=n_samples)
    return float(nll_loss(y_pred, trainer._tensor(y_te[:, :GAMMA, :])))


def make_grid(path: str) -> int:
    """The 3 encoders x hidden 32/64/128 grid, as the JAX script's
    ``pd.DataFrame(rows).to_csv(path)`` writes it (its index column included)."""
    rows = [dict(encoder=e, latent_dim=6, hidden_size=h, window_size=28, batch_size=32,
                 n_samples=16, epochs=20, started=0, score=10.0)
            for e, h in itertools.product(["back_gru", "bigru", "bilstm"], [32, 64, 128])]
    atomic_write_table(path, COLUMNS, list(range(len(rows))), rows)
    return len(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("worker_id", type=int, nargs="?", default=0)
    ap.add_argument("--csv", default="encoder_scores.csv")
    ap.add_argument("--make-grid", action="store_true")
    ap.add_argument("--max-rows", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (the card when omitted); rows are stamped with its "
                         "type in a 'platform' provenance column")
    args = ap.parse_args(argv)

    if args.make_grid:
        print(f"wrote {make_grid(args.csv)} rows to {args.csv}")
        return
    device = resolve_device(args.device)

    def timed(params):
        start = time.perf_counter()
        score = evaluate(params, device)
        print(f"{params['encoder']} hidden {params['hidden_size']}: score {score!r} in "
              f"{time.perf_counter() - start:.2f} s", flush=True)
        return score

    n = run_tuning_worker(args.csv, timed, max_rows=args.max_rows,
                          extra_cols={"platform": device.type})
    print(f"worker {args.worker_id}: processed {n} rows")


if __name__ == "__main__":
    main()
