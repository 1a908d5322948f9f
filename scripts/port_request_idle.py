#!/usr/bin/env python3
"""Where the card idles inside a forecast request of the benchmark's two
forecast cells: split between the program's phases from its own spans
(traced), and the idle inside the program's call untraced, from CUDA events.

    python3 scripts/port_request_idle.py SEED

For ``state-uonn-forecast`` and ``state-uonnb-forecast`` (at full size on a
card, at the benchmark tests' tiny size on the CPU), requests are built as
the benchmark builds them (``benchmark/forecast.py::Requests``), three are
run to warm up, then:

* traced, 24 requests: the ms a request the card runs neither a kernel nor a
  copy, and the host's ms, in each phase between the spans (``pre``: the grid
  check and the encoder's launch, before ``serve.encode``; ``encode``;
  ``reparam``, between ``serve.encode`` and ``serve.trajectory``;
  ``trajectory``; ``post``), the ms from a request's start to its first
  kernel, and the kernels and their device ms a request;
* untraced, 60 calls of the forecaster alone, each on an idle card: the
  host's ms in the call, the CUDA events' ms around it, and that less the
  traced kernels' device ms: the idle inside the program's call; and the us
  of ``uniform_step``, the grid check, alone.

Prints one line ``REQUEST_IDLE {json}`` a cell."""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:0] = [ROOT, os.path.join(ROOT, "benchmark", "tests")]

import torch  # noqa: E402

from bench_tiny import full_cell, tiny_cell  # noqa: E402
from benchmark import forecast  # noqa: E402
from benchmark.trace import Trace, profiler  # noqa: E402
from fiude_tpu_torch.ops.fused_ude import uniform_step  # noqa: E402

PHASES = ("pre", "encode", "reparam", "trajectory", "post")


def traced(req, dev, n):
    with profiler() as prof:
        for k in range(n):
            req(k)
        forecast.sync(dev)
    t = Trace(prof)
    spans = (sorted(t.spans[s]) for s in ("serve.request", "serve.encode", "serve.trajectory"))
    idle, host, first = dict.fromkeys(PHASES, 0), dict.fromkeys(PHASES, 0), []
    requests = []
    for (rs, re), (es, ee), (js, je) in zip(*spans):
        requests.append((rs, re))
        for key, (a, b) in zip(PHASES, [(rs, es), (es, ee), (ee, js), (js, je), (je, re)]):
            idle[key] += (b - a) - t.busy(a, b, copies=True)
            host[key] += b - a
        first.append(min([s for s, *_ in t.kernels if s >= rs] or [rs]) - rs)
    launched = [k for k in t.kernels
                if k[3] is not None and any(a <= k[3] <= b for a, b in requests)]
    return {"traced_idle_ms": {k: v / n / 1e6 for k, v in idle.items()},
            "traced_host_ms": {k: v / n / 1e6 for k, v in host.items()},
            "traced_first_kernel_ms": statistics.median(first) / 1e6,
            "kernels_a_request": len(launched) / n,
            "kernel_ms_a_request": sum(e - s for s, e, *_ in launched) / n / 1e6}


def untraced(req, dev, seed, calls=60):
    cuda = dev.type == "cuda"
    elapsed, enqueue = [], []
    for i in range(calls):
        k = i % len(req.x)
        x = req.x[k].to(dev)
        forecast.sync(dev)
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        h0 = time.perf_counter()
        if req.bayes:
            req.forecaster(x, req.t, req.eps[k], seed=seed + i)
        else:
            req.forecaster(x, req.t, req.eps[k])
        enqueue.append(time.perf_counter() - h0)
        if cuda:
            b.record()
        forecast.sync(dev)
        if cuda:
            elapsed.append(a.elapsed_time(b))
    out = {"untraced_host_call_ms": statistics.median(enqueue) * 1e3}
    if cuda:
        out["untraced_event_ms"] = statistics.median(elapsed)
    return out


def main():
    seed = int(sys.argv[1])
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    torch.set_num_threads(1)
    for name in ("state-uonn-forecast", "state-uonnb-forecast"):
        cell = full_cell(name) if cuda else tiny_cell(name)
        req = forecast.Requests(cell, seed, dev)
        for i in range(3):
            req(-1 - i)
        forecast.sync(dev)
        res = {"cell": name, **traced(req, dev, 24)}
        t0 = time.perf_counter()
        for _ in range(2000):
            uniform_step(req.t)
        res["uniform_step_us"] = (time.perf_counter() - t0) / 2000 * 1e6
        res.update(untraced(req, dev, seed=1000))
        if cuda:
            res["untraced_idle_ms"] = res["untraced_event_ms"] - res["kernel_ms_a_request"]
        print("REQUEST_IDLE " + json.dumps(res), flush=True)
        req.free()
        del req
        if cuda:
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
