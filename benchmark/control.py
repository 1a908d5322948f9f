"""The readings that the limits in ``limits/<cell>.json`` are set from, at
the cell's own size on the card (the benchmark's runs never run this):

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... --control-seeds 21 22 23

* the program's numbers on each of ``--seeds``, as a run compares them (a
  forecast cell after a short window, a training cell after its checked
  steps, which need no window): the lower reading is their largest;
* the control's on each of ``--control-seeds``: the reference computed in
  TF32 put in the program's place (the step below the configuration's
  float32 that would tempt a later change), held against the float64
  reference as the program is: its smallest is the upper reading;
* for a training cell, the faults planted in the reference put in the
  program's place: a step that leaves the state unchanged, and half of the
  batch left out with the mean taken over the rest.

Each reading is held to the cell's limits (``limits/<cell>.json``) as a run
holds its numbers, and says whether it came out ``correct``: the program's
have to, the control's and the faults' must not.  One JSON line a reading on
standard output, then a summary line.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import checks, forecast, population, spec  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference.params import param_specs, unflatten  # noqa: E402


def correct(numbers, limits) -> bool:
    """Whether ``numbers`` hold every limit, as a run's ``correct`` does."""
    return all(h["ok"] for h in checks.held(numbers, limits))


def serve_control(cell, seed: int, device, prec: str = "tf32"):
    """The reference in ``prec`` in the program's place, on a run's sampled
    number of requests of the pool."""
    req = forecast.Requests(cell, seed, device)
    req.free()
    ref.plain_math()
    p = unflatten(req.flat, param_specs(req.cfg))
    p_ref, p_ctl = ref.cast(p, "float64"), ref.cast(p, prec)
    errors = []
    for i in range(cell.traffic["check_requests"]):
        seed_i = int(req.noise.integers(0, 2 ** 31 - 1)) if req.bayes else None
        x, eps = req.x[i % len(req.x)].to(device), req.eps[i % len(req.x)]
        y = ref.forecast(p_ctl, req.cfg, x.to(ref.dtype_of(prec)), eps.to(ref.dtype_of(prec)),
                         req.T, 1.0 / 7.0, prec, noise_seed=seed_i)
        y_ref = ref.forecast(p_ref, req.cfg, x.double(), eps.double(), req.T, 1.0 / 7.0,
                             "float64", noise_seed=seed_i)
        errors.append(checks.trajectory_errors(y, y_ref))
    return checks.serve_numbers(errors)


def train_control(job, base, fault=None, prec="float64"):
    """The reference with ``fault``, or in ``prec``, held against ``base``,
    the float64 reference's readings."""
    return checks.train_numbers(job.reference(fault=fault, prec=prec), base)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.5)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    training = cell.traffic["kind"] == "population"
    rows = []

    def emit(kind, seed, numbers):
        ok = correct(numbers, cell.limits)
        rows.append((kind, ok, numbers))
        print(json.dumps({"kind": kind, "seed": seed, "correct": ok, **numbers}), flush=True)

    for seed in args.seeds:
        if training:
            job = population.Population(cell, seed, device)
            readings = job.set_up()
            job.pop = None
            ref.plain_math()
            emit("program", seed, checks.train_numbers(readings, job.reference()))
        else:
            out = forecast.run(cell, seed, args.seconds, False, device, time.perf_counter())
            emit("program", seed, out["numbers"])
        torch.cuda.empty_cache() if device.type == "cuda" else None
    for seed in args.control_seeds:
        if training:
            job = population.Population(cell, seed, device)
            job.pop = None
            ref.plain_math()
            base = job.reference()
            emit("control", seed, train_control(job, base, prec="tf32"))
            emit("half_batch", seed, train_control(job, base, fault="half_batch"))
            emit("unchanged", seed, train_control(job, base, fault="unchanged"))
        else:
            emit("control", seed, serve_control(cell, seed, device))
    summary = {}
    for kind, ok, numbers in rows:
        kind_summary = summary.setdefault(kind, {"correct": 0, "not_correct": 0})
        kind_summary["correct" if ok else "not_correct"] += 1
        for k, v in numbers.items():
            lo, hi = kind_summary.get(k, (v, v))
            kind_summary[k] = (min(lo, v), max(hi, v))
    print(json.dumps({"summary": summary, "device": str(device)}))


if __name__ == "__main__":
    main()
