"""End-to-end accuracy demonstration on synthetic surveillance data
(counterpart of ``scripts/demo_accuracy.py``).

Trains CONN (mechanistic SIR + neural rates) and UONN (universal ODE) with
the reference training recipe (growing-horizon curriculum, MC-ensemble NLL,
KL terms) on SIR-driven synthetic data through the port's
:func:`~fiude_tpu_torch.train.experiment.run_experiment`, then evaluates
horizon NLL and skill through the metric pipeline the reference used for
``results_table.csv``.  It trains on the plain path, as the JAX script does
(``run_experiment``'s ``fused_train`` defaults to False in both packages).

Writes ``summary.json``, ``RESULTS_SYNTH.md`` and ``demo_results.csv`` in
``--out-dir``:

    python -m fiude_tpu_torch.scripts.demo_accuracy --out-dir demo_out [--device cpu]
"""
import argparse
import json
import os
import time

from fiude_tpu_torch.models.vae import resolve_device
from fiude_tpu_torch.train.experiment import run_experiment
from fiude_tpu_torch.utils.config import REGION_INFO, ExperimentConfig


def register_demo(epochs: int) -> None:
    """The ``demo`` preset of the JAX script in ``REGION_INFO``: one region,
    latent 8, 20 queries, nets (64, 64, 32) / (64, 64), encoder (128, 64) /
    (64,)."""
    REGION_INFO["demo"] = {
        "n_regions": 1, "latent_dim": 8, "n_qs": 20,
        "ode_params": {"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)},
        "dec_params": {},
        "enc_params": {"q_sizes": (128, 64), "ff_sizes": (64,),
                       "SIR_scaler": [0.1, 0.05, 1.0]},
        "epochs": epochs,
    }


def demo_config(ode_name: str, epochs: int) -> ExperimentConfig:
    return ExperimentConfig(region="demo", ode_name=ode_name, test_season=2016, epochs=epochs,
                            window_size=28, gamma=28, num=1, n_samples=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--epochs", type=int, default=56)
    ap.add_argument("--models", nargs="+", default=["CONN", "UONN"])
    ap.add_argument("--device", default=None,
                    help="torch device (the card when omitted; `cpu` runs the plain path there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    register_demo(args.epochs)

    rows = []
    for ode_name in args.models:
        cfg = demo_config(ode_name, args.epochs)
        start = time.time()
        out = run_experiment(cfg, synthetic=True, weights_root=args.out_dir,
                             results_file=os.path.join(args.out_dir, "demo_results"),
                             validate_each_epoch=False, verbose=True, device=device)
        mins = (time.time() - start) / 60
        hist = out["history"]
        rows.append({
            "model": ode_name,
            "first_epoch_nll": hist[0]["nll"],
            "final_epoch_nll": hist[-1]["nll"],
            "final_loss": hist[-1]["loss"],
            "minutes": round(mins, 1),
            **{k: round(float(v), 4) for k, v in out["metrics"].items()},
        })
        print(ode_name, rows[-1], flush=True)

    with open(os.path.join(args.out_dir, "summary.json"), "w") as fh:
        json.dump(rows, fh, indent=2)

    lines = ["# Synthetic-data accuracy demonstration",
             "",
             "Reference training recipe (growing-horizon curriculum, 64-sample",
             "MC ensemble, NLL+KL loss stack) on SIR-driven synthetic national",
             "data; metrics via the reference results-table pipeline.",
             ""]
    for r in rows:
        lines.append(f"## {r['model']}")
        lines.append("")
        lines.append(f"- train NLL: {r['first_epoch_nll']:.3f} (epoch 1) -> "
                     f"{r['final_epoch_nll']:.3f} (final epoch)")
        for k, v in r.items():
            if k.startswith("2016") or k.startswith("skill"):
                lines.append(f"- {k}: {v}")
        lines.append(f"- wall clock: {r['minutes']} min")
        lines.append("")
    with open(os.path.join(args.out_dir, "RESULTS_SYNTH.md"), "w") as fh:
        fh.write("\n".join(lines))
    print("wrote", os.path.join(args.out_dir, "RESULTS_SYNTH.md"))
    return rows


if __name__ == "__main__":
    main()
