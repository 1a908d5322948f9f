"""The CONN -> UONN transfer-learning command (reference ``testing_pre_train.py``;
counterpart of ``scripts/run_transfer.py``).

Loads trained CONN weights (saved under the same ``--work-dir`` by a sweep
whose epochs are ``--conn-epochs``) into a UONN and runs the fa_w ramp
recipe, each config claimed through the ledger; ``--out`` upserts UONN_pre
rows into a results table.
"""
import argparse
import os

from fiude_tpu_torch.models.vae import resolve_device
from fiude_tpu_torch.parallel.sweep import run_work_queue
from fiude_tpu_torch.train.experiment import _build_data, daily_grid, run_transfer
from fiude_tpu_torch.utils.config import ExperimentConfig, grid
from fiude_tpu_torch.utils.ledger import Ledger
from fiude_tpu_torch.utils.results import evaluate_forecast, upsert_results_row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--regions", nargs="+", default=["US", "state", "hhs"])
    ap.add_argument("--seasons", nargs="+", type=int, default=[2015, 2016, 2017, 2018])
    ap.add_argument("--nums", nargs="+", type=int, default=[1, 2, 3, 4, 5])
    ap.add_argument("--window", type=int, default=28)
    ap.add_argument("--gamma", type=int, default=28)
    ap.add_argument("--final-epochs", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=120,
                    help="epochs label of the UONN config (its weights key and results-row id)")
    ap.add_argument("--conn-epochs", type=int, default=None,
                    help="epochs of the CONN run whose weights to load (part of its weights "
                         "key); defaults to the UONN config's epochs")
    ap.add_argument("--work-dir", default=".")
    ap.add_argument("--out", default=None,
                    help="results table to upsert UONN_pre rows into (reference "
                         "testing_pre_train.py -> utils.test)")
    ap.add_argument("--fused-train", action="store_true",
                    help="train through the hand-written kernels (fa_w is a run-time scalar)")
    ap.add_argument("--device", default=None, help="torch device (the card when omitted)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    configs = grid(region=args.regions, test_season=args.seasons, num=args.nums,
                   ode_name=["UONN"], epochs=[args.epochs], window_size=[args.window],
                   gamma=[args.gamma])
    ledger = Ledger(os.path.join(args.work_dir, "started.txt"))

    def worker(cfg):
        # the CONN run saved under its own cfg.key (run_sweep / run_experiment
        # convention: {region}/CONN/{season}_e{E}_g{G}_w{W}_{num}_)
        conn_cfg = ExperimentConfig(
            region=cfg.region, ode_name="CONN", test_season=cfg.test_season,
            epochs=args.conn_epochs if args.conn_epochs is not None else cfg.epochs,
            window_size=cfg.window_size, gamma=cfg.gamma, num=cfg.num)
        tr = run_transfer(cfg, load_prefix=os.path.join(args.work_dir, "weights", conn_cfg.key),
                          data_root=args.data_root, synthetic=args.synthetic,
                          # an own subtree: the UONN_pre weights share the UONN
                          # cfg.key and must not clobber a direct-UONN run
                          weights_root=os.path.join(args.work_dir, "transfer"),
                          final_epochs=args.final_epochs, fused_train=args.fused_train,
                          device=device)
        out = {"loss": tr.history.epoch_history[-1]["loss"]}
        if args.out is not None:
            _, _, x_te, y_te, scaler = _build_data(cfg, args.data_root, args.synthetic)
            t = daily_grid(cfg)
            y_pred = tr.forecast(x_te, t, n_samples=128).cpu().numpy()
            values = evaluate_forecast(y_pred, y_te[:, : len(t)], scaler,
                                       window_size=cfg.window_size, test_season=cfg.test_season)
            upsert_results_row(args.out,
                               {"epochs": cfg.epochs, "gamma": cfg.gamma, "ode_name": "UONN_pre",
                                "region": cfg.region, "latent_dim": cfg.latent_dim,
                                "window_size": cfg.window_size, "num": cfg.num},
                               values)
            out.update(values)
        return out

    # the full dimension tuple is in the key: a later sweep with other
    # --epochs/--window/--gamma in the same work dir is new work, not a dup
    results = run_work_queue(configs, worker, ledger=ledger,
                             key_fn=lambda c: f"weights/{c.region}/pre_trained_UONN/"
                                              f"{c.test_season}_e{c.epochs}_g{c.gamma}"
                                              f"_w{c.window_size}_{c.num}_")
    done = sum(1 for r in results if r is not None)
    print(f"processed {done}/{len(configs)} configs")


if __name__ == "__main__":
    main()
