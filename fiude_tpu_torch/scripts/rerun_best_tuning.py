"""Re-run the top-N tuning configs (reference ``lib/Old/test_odes.py:268-358``;
counterpart of ``scripts/rerun_best_tuning.py``): sort the validation-score
table, re-run each of the top ``--run-best`` configs ``--run-each`` times
with fresh seeds, dump per-run JSON forecasts, and write a
``test_scores.csv`` summary.

Usage:
    python -m fiude_tpu_torch.scripts.rerun_best_tuning \\
        --csv docs/validation_scores_synth.csv --out best_runs --run-best 10 --run-each 3
"""
import argparse

from fiude_tpu_torch.models.vae import resolve_device
from fiude_tpu_torch.scripts.tune_worker import tuning_run
from fiude_tpu_torch.train.experiment import rerun_best
from fiude_tpu_torch.train.losses import nll_loss


def evaluate(params: dict, rep: int, device) -> dict:
    """One re-run: the tuning worker's protocol seeded by the replicate index,
    returning the forecast dump the reference's best-N re-runs write as JSON
    (truth / predictive mean / std / score)."""
    tmax, pred, truth = tuning_run(params, device, seed=rep)
    pred_np, truth_np = pred.cpu().numpy(), truth.cpu().numpy()
    return {
        "score": float(nll_loss(pred, truth)),
        "tmax": int(tmax),
        "truth": truth_np[:, :, 0],
        "pred_mean": pred_np.mean(axis=1)[:, :, 0],
        "pred_std": pred_np.std(axis=1)[:, :, 0],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", default="docs/validation_scores_synth.csv")
    ap.add_argument("--out", default="best_runs")
    ap.add_argument("--run-best", type=int, default=10)
    ap.add_argument("--run-each", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (the card when omitted)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_csv = rerun_best(args.csv, lambda params, rep: evaluate(params, rep, device),
                         run_best=args.run_best, run_each=args.run_each, out_dir=args.out)
    print(f"wrote {out_csv}")


if __name__ == "__main__":
    main()
