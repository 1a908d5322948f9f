"""Run one cell of the benchmark of ``fiude_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix,
its metrics and its limits are found by name (``spec.py``).  The run makes
its weights and inputs from ``--seed``, warms up every shape the cell uses
(counted in ``setup_s``), measures for ``--seconds``, and checks what the
timed path produced against the plain reference.  With ``--trace 1`` it also
traces a stretch after the window and reports the per-layer metrics in
place of the end-to-end ones.  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.

It exits with a code other than 0, printing no result, when there is no
CUDA card (or fewer than the cell asks for), and when the process holds a
module of JAX or of the JAX package once the window has closed.
"""

import time

CLOCK = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level module names the measured process may not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "fiude_tpu",
             "forecasting_influenza_using_universal_differential_equations_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def traffic_module(cell):
    """The module that runs the cell's kind of traffic: ``benchmark/<kind>.py``."""
    return importlib.import_module(f"benchmark.{cell.traffic['kind']}")


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Ctx:
    """What a per-layer metric's reader gets: the cell, the reduced trace of
    the traced stretch and its bounds, the windows of each unit (request or
    member-step) it held, the points of a trajectory and the days of a
    window, and the untraced window's seconds a unit."""

    def __init__(self, cell, out, kind):
        from benchmark import work
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.trace = out["trace"]["trace"]
        self.batches = out["trace"]["batches"]      # windows of each unit traced
        self.units = len(self.batches)
        self.points, self.steps_in = out["points"], out["steps_in"]
        self.unit_s = out["unit_s"]
        self.lo, self.hi = self.trace.stretch(out["trace"]["span"])
        self.peak = work.peaks(kind)
        self.work = work


def report(cell, out, traced: bool, device) -> dict:
    import torch
    from benchmark import checks
    from benchmark.spec import metric_module
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    held = checks.held(out["numbers"], cell.limits)
    result = {"correct": all(h["ok"] for h in held), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                         "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}}
    if traced:
        ctx = Ctx(cell, out, kind)
        for m in cell.per_layer:
            value = metric_module(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"]["busy_s"] = ctx.trace.busy(ctx.lo, ctx.hi, copies=True) / 1e9
        result["device"]["window_s"] = (ctx.hi - ctx.lo) / 1e9
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(ctx.lo, ctx.hi),
                               "idle_gaps": ctx.trace.idle_gaps(ctx.lo, ctx.hi)}
        result["card"] = {"power_limit_w": power_limit_w() if device.type == "cuda" else None,
                          "kernels_without_launch": ctx.trace.unmatched,
                          "kernels": len(ctx.trace.kernels)}
    else:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    if "setup_stages" in out:
        result["setup_stages"] = out["setup_stages"]
    result["checks"] = {h["name"]: {"value": h["value"], "limit": h["limit"]} for h in held}
    return result, held


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    # one intra-op thread: the measured paths run no CPU tensor work, and idle
    # threads beside the host's enqueue only widen the spread between runs
    torch.set_num_threads(1)
    from benchmark import spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = traffic_module(cell).run(cell, args.seed, args.seconds, bool(args.trace), device, CLOCK)
    bad = forbidden_modules()
    if bad:
        print(f"the measured process holds {bad}: no result", file=sys.stderr)
        return 3
    result, held = report(cell, out, bool(args.trace), device)
    print("numbers " + json.dumps(out["numbers"]), file=sys.stderr)
    for h in held:
        print(f"check {h['name']} = {h['value']!r} (limit {h['limit']!r}) "
              f"{'ok' if h['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # the checkout's root, in place of this file's folder, whose modules would
    # otherwise shadow the standard library's (``trace``)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
