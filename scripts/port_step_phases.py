#!/usr/bin/env python3
"""The host's ms a member-step in each phase of the training step, from the
program's own spans, over one traced epoch of the benchmark's staged
population cell (``state-uonn-popstep``, ``benchmark/tests/bench_tiny.py``).

    python3 scripts/port_step_phases.py SEED

At full size on a card, at the benchmark tests' tiny size on the CPU: one
untraced epoch (its ms a member-step), then the benchmark's traced epoch
(``benchmark/population.py::trace_stretch``).  For ``train.step`` and its
children ``train.loss``, ``train.backward``, ``train.adam``, and for the
epoch span, prints the spans seen, the host's ms a member-step inside them,
the runtime launches and the ms the card runs neither a kernel nor a copy
there; and ``host_ms.train`` as its reader reads it.  One line
``POPSTEP {json}``."""

import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:0] = [ROOT, os.path.join(ROOT, "benchmark", "tests")]

import torch  # noqa: E402

from bench_tiny import POPSTEP, full_cell, tiny_cell  # noqa: E402
from benchmark import population, spec  # noqa: E402

SPANS = ("train.step", "train.loss", "train.backward", "train.adam", "PopulationTrainer.epoch")


def main():
    seed = int(sys.argv[1])
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        cell = full_cell(POPSTEP)
    else:
        device, cell = torch.device("cpu"), tiny_cell(POPSTEP)
    job = population.Population(cell, seed, device)
    job.set_up()
    population.sync(device)
    t0 = time.perf_counter()
    steps = job.epoch()
    population.sync(device)
    res = {"seed": seed, "untraced_epoch_ms_a_step": (time.perf_counter() - t0) / steps * 1e3}
    out = population.trace_stretch(cell, job, device)
    t, units = out["trace"], len(out["batches"])
    lo, hi = t.stretch("bench.epoch")
    res.update(member_steps=units, window_ms_a_step=(hi - lo) / 1e6 / units,
               busy_ms_a_step=t.busy(lo, hi, copies=True) / 1e6 / units)
    for name in SPANS:
        sp = t.spans.get(name, [])
        res[name] = {"spans": len(sp), "ms_a_step": sum(e - s for s, e in sp) / 1e6 / units,
                     "launches_a_step": t.launches_in(name) / units,
                     "idle_ms_a_step": sum(e - s - t.busy(s, e, copies=True)
                                           for s, e in sp) / 1e6 / units}
    res["host_ms.train"] = spec.metric_module("host_ms.train").read(
        types.SimpleNamespace(trace=t, units=units))
    print("POPSTEP " + json.dumps(res))


if __name__ == "__main__":
    main()
