"""Generate a tuning-grid CSV (reference ``tuning/tuning_file_maker.ipynb``;
counterpart of ``scripts/make_tuning_grid.py``): the cartesian product of
hyperparameters with ``started`` / ``score`` bookkeeping columns, consumed
row by row by ``python -m fiude_tpu_torch.scripts.tune_worker``."""
import argparse
import itertools
import os

from fiude_tpu_torch.utils.results import atomic_write_table, file_lock, read_table

KEYS = ["latent_dim", "hidden_size", "window_size", "batch_size", "n_samples", "epochs"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="validation_scores.csv")
    ap.add_argument("--latent-dims", nargs="+", type=int, default=[6, 8])
    ap.add_argument("--hidden-sizes", nargs="+", type=int, default=[32, 64, 128])
    ap.add_argument("--window-sizes", nargs="+", type=int, default=[14, 28, 42])
    ap.add_argument("--batch-sizes", nargs="+", type=int, default=[32])
    ap.add_argument("--n-samples", nargs="+", type=int, default=[32])
    ap.add_argument("--epochs", nargs="+", type=int, default=[50])
    ap.add_argument("--extend", action="store_true",
                    help="append only combos not already in --out, keeping existing rows (and "
                         "their started/score) intact; takes the same file lock the workers use")
    args = ap.parse_args(argv)

    rows = [dict(zip(KEYS, combo), started=0, score=10.0) for combo in itertools.product(
        args.latent_dims, args.hidden_sizes, args.window_sizes, args.batch_sizes,
        args.n_samples, args.epochs)]
    columns = KEYS + ["started", "score"]
    if args.extend and os.path.exists(args.out):
        with file_lock(args.out + ".lock"):
            old_columns, _, old = read_table(args.out)
            have = {tuple(int(r[k]) for k in KEYS) for r in old}
            new = [r for r in rows if tuple(r[k] for k in KEYS) not in have]
            out = old + new
            if new:
                old_columns += [c for c in columns if c not in old_columns]
            atomic_write_table(args.out, old_columns, list(range(len(out))), out)
        print(f"extended {args.out}: {len(old)} existing + {len(new)} new = {len(out)} rows")
        return
    atomic_write_table(args.out, columns, list(range(len(rows))), rows)
    print(f"wrote {len(rows)} rows to {args.out}")


if __name__ == "__main__":
    main()
