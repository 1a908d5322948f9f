"""The readers of the program's own spans (``fiude_tpu_torch/utils/profiler.py``):
``host_idle_ms.serve`` (``serve.request``), ``traj_span_roofline.serve``
(``serve.trajectory``), ``enc_span_roofline.serve`` (``serve.encode``) and the
staged ``host_ms.train`` (``train.step``).

* Tiny traced runs on the CPU give every reader a value: with no kernel on
  the CPU the card idles through each ``serve.request`` span, and kernels put
  into the trace at launches inside the benchmark's wrapper spans read the
  same in each span roofline as in its wrapper twin;
* a trace without the program's spans (a program that lacks them) gives no
  reading (``test_bench_work.py`` feeds each span roofline the least time,
  through ``benchmark/conftest.py``);
* on the card, in one traced stretch of each cell, ``serve.trajectory`` and
  ``serve.encode`` hold exactly the kernels of the matching wrapper spans.
"""

import time

import pytest
import torch

from bench_tiny import POPSTEP, full_cell, staged
from benchmark import forecast, population, run, spec
from benchmark.trace import BWD, FWD, Trace
from test_bench_card import card
from test_bench_work import FakeTrace, fake_ctx

CPU = torch.device("cpu")
FORECASTS = ["state-uonn-forecast", "state-uonnb-forecast"]
SPANS = ["host_idle_ms.serve", "traj_span_roofline.serve", "enc_span_roofline.serve"]
#: each span roofline: the program's span, and its twin that reads the wrapper spans
TWINS = {"traj_span_roofline.serve": ("serve.trajectory", "traj_roofline.serve"),
         "enc_span_roofline.serve": ("serve.encode", "enc_roofline.serve")}
#: the card whose peaks the rooflines of a CPU run are read against
H100 = "NVIDIA H100 80GB HBM3"
HOST_MS_TRAIN = {"name": "host_ms.train", "unit": "ms", "better": "lower",
                 "source": "program_span", "layer": "Training entry", "moves": "train_step_ms",
                 "workloads": [POPSTEP]}


def wrapper_spans(metric: str):
    entries = spec.metric_module(metric).ENTRY_POINTS
    return [p + e for e in entries for p in (FWD, BWD)]


def readings(cell, ctx):
    """Every per-layer metric of ``cell`` read from ``ctx``, as a run reports
    them: those that read nothing left out."""
    values = {m["name"]: spec.metric_module(m["name"]).read(ctx) for m in cell.per_layer}
    return {k: v for k, v in values.items() if v is not None}


def launched_in(trace: Trace, names):
    """The kernels of ``trace`` whose launch lies inside a span named in ``names``."""
    spans = [sp for n in names for sp in trace.spans.get(n, [])]
    return {k for k in trace.kernels
            if k[3] is not None and any(s <= k[3] <= e for s, e in spans)}


@pytest.mark.parametrize("name", FORECASTS)
def test_a_traced_run_reads_every_span_metric(tiny, name):
    cell = tiny(name)
    assert {m["name"] for m in cell.per_layer} >= set(SPANS)
    out = forecast.run(cell, 2147483729, 0.2, True, CPU, time.perf_counter())
    ctx = run.Ctx(cell, out, H100)
    trace = ctx.trace
    requests = trace.spans["serve.request"]
    assert len(requests) == ctx.units == cell.traffic["trace_requests"]
    for child in ("serve.encode", "serve.trajectory"):
        assert len(trace.spans[child]) == ctx.units
    # no kernel on the CPU: the card idles through the program's span
    idle = spec.metric_module("host_idle_ms.serve").read(ctx)
    assert idle > 0
    assert idle == pytest.approx(sum(e - s for s, e in requests) / 1e6 / ctx.units)
    idle_pct = spec.metric_module("idle_pct.serve").read(ctx)
    assert idle <= idle_pct / 100.0 * (ctx.hi - ctx.lo) / 1e6 / ctx.units
    # a kernel launched inside each wrapper span, 1 ms on the card, and one
    # launched between encode and trajectory (reparam's), which neither holds
    fake = []
    for metric, (program, twin) in TWINS.items():
        for s, e in sorted(sp for n in wrapper_spans(twin) for sp in trace.spans.get(n, [])):
            fake.append((e + 1000, e + 1_001_000, f"fake {metric}", (s + e) // 2))
    for (_, enc_end), (traj_start, _) in zip(sorted(trace.spans["serve.encode"]),
                                             sorted(trace.spans["serve.trajectory"])):
        fake.append((traj_start, traj_start + 5_000_000, "fake reparam",
                     (enc_end + traj_start) // 2))
    trace.kernels = sorted(trace.kernels + fake)
    values = readings(cell, ctx)
    assert set(values) >= set(SPANS)
    for metric, (program, twin) in TWINS.items():
        assert values[metric] == pytest.approx(values[twin], rel=1e-12)
        held = launched_in(trace, [program])
        assert len(held) == ctx.units and held == launched_in(trace, wrapper_spans(twin))


def test_host_ms_train_reads_the_staged_popstep(tiny):
    bench = staged()
    bench["per_layer"].append(HOST_MS_TRAIN)
    cell = tiny(POPSTEP)
    cell = cell._replace(per_layer=spec.cell(POPSTEP, bench).per_layer)
    assert "host_ms.train" in [m["name"] for m in cell.per_layer]
    out = population.run(cell, 2147483731, 0.2, True, CPU, time.perf_counter())
    ctx = run.Ctx(cell, out, H100)
    steps = ctx.trace.spans["train.step"]
    assert len(steps) == ctx.units         # one span a member-step
    value = readings(cell, ctx)["host_ms.train"]
    assert value > 0
    assert value == pytest.approx(sum(e - s for s, e in steps) / 1e6 / ctx.units)
    for phase in ("train.loss", "train.backward", "train.adam"):
        assert len(ctx.trace.spans[phase]) == ctx.units


@pytest.mark.parametrize("name", SPANS + ["host_ms.train"])
def test_a_program_without_the_spans_gives_no_reading(name):
    module = spec.metric_module(name)
    cell = POPSTEP if name.endswith(".train") else FORECASTS[0]

    class ParentTrace(FakeTrace):
        spans = {"bench.request": [(0, 10)], FWD + "x": [(0, 5)]}

    assert module.read(fake_ctx(cell, ParentTrace(1_000_000_000))) is None


def test_the_new_metrics_are_listed_as_program_spans():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in SPANS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["workloads"] == FORECASTS
    assert "host_ms.train" not in per_layer          # staged with the population cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", FORECASTS)
def test_the_program_spans_hold_exactly_the_wrappers_kernels(name):
    device = card()
    cell = full_cell(name)
    req = forecast.Requests(cell, 2147483737, device)
    for i in range(cell.traffic["warmup_requests"]):
        req(-1 - i)
    trace = forecast.trace_stretch(cell, req, 0, device)["trace"]
    n = cell.traffic["trace_requests"]
    assert len(trace.spans["serve.request"]) == n and not trace.unmatched
    for program, twin in TWINS.values():
        mine = launched_in(trace, [program])
        assert mine and mine == launched_in(trace, wrapper_spans(twin)), program
    # a request's K1 in its encode span; its K2, or its draw and K7, in its trajectory span
    named = {"serve.encode": ["backgru_cluster_kernel"],
             "serve.trajectory": ["ude_trajectory_kernel"] + (["bayes_draw_kernel"]
                                                              if "uonnb" in name else [])}
    for program, kernels in named.items():
        held = [k[2] for k in launched_in(trace, [program])]
        for kernel in kernels:
            assert sum(kernel in k for k in held) == n, (program, kernel)
