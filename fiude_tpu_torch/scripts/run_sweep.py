"""The main sweep command (reference ``run_ode.py``; counterpart of
``scripts/run_sweep.py``).

Runs the region x epochs x window x gamma x num x season x model grid with
the growing-horizon curriculum, a crash-resumable ledger (shared with the
JAX package's workers) and file-locked results tables.  Works against a real
``Data/`` tree or ``--synthetic``.  ``--population`` trains each group of
configs that differ only in ``num`` as one population
(``parallel/sweep.py``); it ignores ``--padded`` and ``--fill-1``, as the
JAX script does.  ``--summary`` prints the region x model table of the
results (``scripts/summarize_results.py``) after the sweep.

Under ``torchrun`` (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
set) the ranks make one process group (``parallel/distributed.py``), each on
``cuda:LOCAL_RANK`` unless ``--device`` names its device, NCCL on a card
unless ``--backend`` names another.  With ``--population`` rank 0 claims
each group in the ledger and tells the others; a group of ``n > 1``
members on a world of at least ``n`` ranks is split over a ``config`` mesh
of its ``n`` first ranks (the JAX script's rule, ``scripts/run_sweep.py:
136``), any other group trains on rank 0; rank 0 writes the rows.  The
config mesh of each group size is made once, in the same order on every
rank (a mesh's process groups live as long as the world).  A rank with no
place in a group waits in the next claim's broadcast while the group
trains, for hours at the default epochs: so the sweep's process group waits
``SWEEP_TIMEOUT`` (a year) where the library waits ten minutes
(``distributed.TIMEOUT``).  A rank that fails hangs no one: torchrun stops
every rank of the world when one exits with an error.  Without
``--population`` every rank runs the queue and the ledger shares the
configs out.

Examples:
    python -m fiude_tpu_torch.scripts.run_sweep --synthetic --regions US \\
        --nums 1 2 --seasons 2016 --epochs 24 --windows 7 --gammas 28
    python -m fiude_tpu_torch.scripts.run_sweep --synthetic --population \\
        --fused-train --skip-done --regions state --models UONN \\
        --seasons 2016 --epochs 4 --windows 28 --gammas 28 --nums 15 16 17
    torchrun --nproc-per-node 2 -m fiude_tpu_torch.scripts.run_sweep \\
        --synthetic --population --fused-train --regions state --models UONN \\
        --seasons 2016 --epochs 4 --windows 28 --gammas 28 --nums 15 16
"""
import argparse
import datetime
import os

from fiude_tpu_torch.models.vae import resolve_device
from fiude_tpu_torch.parallel import distributed
from fiude_tpu_torch.parallel.mesh import config_mesh
from fiude_tpu_torch.parallel.sweep import (
    group_configs_for_population, run_population_experiment, run_work_queue,
)
from fiude_tpu_torch.scripts.summarize_results import format_summary, summarize
from fiude_tpu_torch.train.experiment import run_experiment
from fiude_tpu_torch.utils.config import grid
from fiude_tpu_torch.utils.ledger import Ledger
from fiude_tpu_torch.utils.results import read_table

#: How long a rank of the sweep's process group waits for its peers: a rank
#: outside a population's mesh waits while the population trains.
SWEEP_TIMEOUT = datetime.timedelta(days=365)

#: A results row's identity (``run_experiment``'s ``variables``).
ROW_KEYS = ("epochs", "gamma", "ode_name", "region", "latent_dim", "window_size", "num")


def filter_done(configs, csv_path):
    """Drop configs whose (row, season) NLL cell is already filled.

    A config's row identity is the ``variables`` dict used by
    ``run_experiment`` (``ROW_KEYS``); its season lands in column
    ``"{test_season} {window_size+6}"`` (``utils/results.py``, mirroring
    reference ``lib/utils.py:52-54``).
    """
    if not os.path.exists(csv_path):
        return list(configs)
    columns, _, rows = read_table(csv_path)
    keep = []
    for cfg in configs:
        col = f"{cfg.test_season} {cfg.window_size + 6}"
        done = (col in columns and all(k in columns for k in ROW_KEYS)
                and any(col in row and all(row.get(k) == getattr(cfg, k) for k in ROW_KEYS)
                        for row in rows))
        if not done:
            keep.append(cfg)
    return keep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--fill-1", action="store_true",
                    help="no-interpolation mode: weekly-only -1-masked targets")
    ap.add_argument("--fused-train", action="store_true",
                    help="train through the hand-written kernels (K3-K6; K8/K9 for a Bayes "
                         "family)")
    ap.add_argument("--regions", nargs="+", default=["US", "hhs", "state"])
    ap.add_argument("--models", nargs="+", default=["CONN", "UONN"])
    ap.add_argument("--seasons", nargs="+", type=int, default=[2015, 2016, 2017, 2018])
    ap.add_argument("--epochs", nargs="+", type=int, default=[140, 200, 260])
    ap.add_argument("--windows", nargs="+", type=int, default=[1, 8, 15, 22, 29])
    ap.add_argument("--gammas", nargs="+", type=int, default=[35, 42, 49, 56])
    ap.add_argument("--nums", nargs="+", type=int, default=[15, 16, 17, 18, 19])
    ap.add_argument("--out", default="results_table_server")
    ap.add_argument("--work-dir", default=".")
    ap.add_argument("--ledger", default="started.txt")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--padded", action="store_true",
                    help="the masked curriculum: every stage on the one weekly grid, same "
                         "gradients")
    ap.add_argument("--summary", action="store_true",
                    help="print the aggregated region x model table (summarize_results) after "
                         "the sweep")
    ap.add_argument("--population", action="store_true",
                    help="train same-shape config groups (the `nums` axis) as populations")
    ap.add_argument("--skip-done", action="store_true",
                    help="drop configs whose (config, season) cell already has an NLL in the "
                         "output CSV: resumable from the results table when the ledger is gone")
    ap.add_argument("--device", default=None,
                    help="torch device (the card when omitted, cuda:LOCAL_RANK under torchrun; "
                         "`cpu` runs the kernels' plain twins)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend under torchrun (NCCL on a card, gloo on "
                         "the CPU when omitted; gloo lets ranks share one card)")
    args = ap.parse_args(argv)
    if distributed.initialize(backend=args.backend, device=args.device, timeout=SWEEP_TIMEOUT):
        device = distributed.rank_device(args.device)
    else:
        device = resolve_device(args.device)
    try:
        sweep(args, device)
    finally:
        distributed.shutdown()


def sweep(args, device) -> None:
    """The sweep of ``main``'s arguments on ``device`` (this rank's)."""
    configs = grid(region=args.regions, epochs=args.epochs, window_size=args.windows,
                   gamma=args.gammas, latent_dim=[8], num=args.nums,
                   test_season=args.seasons, ode_name=args.models)
    results_file = os.path.join(args.work_dir, args.out)
    if args.skip_done:
        n0 = len(configs)
        configs = filter_done(configs, results_file + ".csv")
        print(f"--skip-done: {n0 - len(configs)}/{n0} cells already in the results table; "
              f"{len(configs)} to run", flush=True)
    ledger = Ledger(os.path.join(args.work_dir, args.ledger))

    if args.population:
        primary = distributed.is_primary_host()
        meshes = {}                 # one config mesh a group size
        done = 0
        for g in group_configs_for_population(configs):
            key = g[0].key + f"_pop{len(g)}"
            if not distributed.broadcast_from_primary(ledger.claim(key) if primary else None):
                continue
            mesh = None
            if distributed.world_size() >= len(g) > 1:
                if len(g) not in meshes:
                    meshes[len(g)] = config_mesh(len(g))
                    if primary:
                        print(f"config mesh of {len(g)} ranks", flush=True)
                mesh = meshes[len(g)]
            if mesh is None and not primary or mesh is not None and not mesh.is_member:
                continue
            if primary:
                print("population:", [c.key for c in g], flush=True)
            try:
                run_population_experiment(g, data_root=args.data_root, synthetic=args.synthetic,
                                          weights_root=args.work_dir, results_file=results_file,
                                          mesh=mesh, fused_train=args.fused_train, device=device)
                if primary:
                    ledger.mark(key, "finished")
                done += len(g)
            except Exception as e:
                if primary:
                    print("population failed:", e, flush=True)
                    ledger.mark(key, "failed")
        if primary:
            print(f"processed {done}/{len(configs)} configs (population mode)")
            print_summary(args, results_file)
        return

    def worker(cfg):
        print(cfg.region, cfg.ode_name, cfg.test_season, cfg.epochs, cfg.num, flush=True)
        out = run_experiment(cfg, data_root=args.data_root, synthetic=args.synthetic,
                             fill_1=args.fill_1, weights_root=args.work_dir,
                             results_file=results_file, validate_each_epoch=True,
                             verbose=args.verbose, padded_curriculum=args.padded,
                             fused_train=args.fused_train, device=device)
        return out["metrics"]

    results = run_work_queue(configs, worker, ledger=ledger)
    done = sum(1 for r in results if r is not None)
    print(f"processed {done}/{len(configs)} configs")
    print_summary(args, results_file)


def print_summary(args, results_file: str) -> None:
    """With ``--summary``, the results table's region x model summary."""
    if not args.summary:
        return
    csv_path = results_file + ".csv"
    if not os.path.exists(csv_path):
        print(f"--summary: no results at {csv_path}")
        return
    columns, _, rows = read_table(csv_path)
    print(format_summary(summarize(columns, rows)))


if __name__ == "__main__":
    main()
