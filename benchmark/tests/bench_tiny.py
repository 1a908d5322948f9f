"""Tiny cells for the CPU tests: each cell at a size a test holds.

The cells are those of ``BENCHMARK.json`` and the staged population cell
``state-uonn-popstep``, whose files are in place for a later PR to list
(``benchmark/README.md``): ``STAGED`` is the checkout's ``BENCHMARK.json``
with that cell and its metrics added."""

import copy

from benchmark import spec

POPSTEP = "state-uonn-popstep"


def staged():
    bench = spec.benchmark()
    bench["workloads"].append({"name": POPSTEP, "config": "state-uonn", "traffic": "popstep",
                               "chips": 1, "why": "staged"})
    bench["end_to_end"].append({"name": "train_step_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": [POPSTEP]})
    for name, unit, better, layer in (
            ("idle_pct.train", "%", "lower", "Training epoch and device"),
            ("launches.train", "launches/step", "lower", "Training entry"),
            ("traj_roofline.train", "%", "higher", "Trajectory kernels"),
            ("enc_roofline.train", "%", "higher", "Encoder kernels"),
            ("mfu.train", "%", "higher", "Whole member-step")):
        bench["per_layer"].append({"name": name, "unit": unit, "better": better,
                                   "source": "device_trace", "layer": layer,
                                   "moves": "train_step_ms", "workloads": [POPSTEP]})
    return bench


STAGED = staged()


def full_cell(name: str):
    """The cell ``name`` at its own size."""
    return spec.cell(name, STAGED)


def tiny_cell(name: str):
    """The cell ``name`` at a size a CPU test holds: 3 regions, 2 queries,
    narrow nets, short windows; its own limits and metrics."""
    cell = full_cell(name)
    cfg, mix = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg.update(n_regions=3, n_qs=2)
    cfg["encoder"].update(q_sizes=[16, 8], ff_sizes=[8, 8])
    cfg["ode"].update(net_sizes=[8, 8, 4], aug_net_sizes=[8, 8])
    if mix["kind"] == "forecast":
        mix.update(windows=2, samples=4, window_days=7, lag_days=3, horizon_days=7, pool=2,
                   warmup_requests=1, check_requests=2, trace_requests=2)
    else:
        mix.update(members=[0, 1], train_windows=10, batch=4, samples=4, window_days=7,
                   lag_days=3, horizon_days=14)
    return cell._replace(config=cfg, traffic=mix)
