"""Traffic of kind ``population``: the sweep's population training step.

The production sweep command trains the replicates ``members`` of one
configuration as one population (``run_sweep --population --fused-train``:
``parallel/sweep.py::_train_members``, with ``fused_train`` and
``fused_stats``).  Here that population trains on ``train_windows``
surveillance windows made from the seed, in batches of ``batch`` windows x
``samples`` draws, over the curriculum's last stage: the weekly grid of the
whole horizon.  The entry is ``PopulationTrainer.train``, one epoch a call,
on a feed whose window order is drawn from the seed.

Set-up builds the population once and drives it, through the same call and
feed, over ``check_steps`` steps on rows that all differ (one step, then the
rest in a second call), reading each member's first gradient from its Adam
state after the first step and its parameters after the last; then it warms
the tail batch's shape and the skip rule's path (epochs after the third).
The window runs whole epochs back to back until ``--seconds`` have passed.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import checks, inputs
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train
from benchmark.reference.params import family, param_specs, unflatten
from benchmark.forecast import model_kwargs, peak_memory, sync

SPAN = "PopulationTrainer.epoch"     # the program's span around a population epoch


class Feed:
    """The loader the trainer reads: the windows, and each epoch's order."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int, rng):
        self.x, self.y, self.batch_size, self.rng = x, y, batch, rng
        self.plan: List[np.ndarray] = []

    def epoch_indices(self) -> np.ndarray:
        return self.plan.pop(0) if self.plan else self.rng.permutation(len(self.x))


class Population:
    """The cell's population, its windows and feed, and the weights it
    started from."""

    def __init__(self, cell, seed: int, device):
        from fiude_tpu_torch.models.vae import UDEForecaster
        from fiude_tpu_torch.parallel.sweep import PopulationTrainer
        from fiude_tpu_torch.train.losses import TRAINING_INFO

        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.device = cfg, mix, device
        rng = np.random.default_rng([seed, 5])
        self.x, self.y = inputs.windows(rng, mix["train_windows"], cfg, mix)
        self.K = inputs.weekly_points(mix)
        self.eval_pts = np.arange(self.K) * 7
        self.t = np.arange(self.eval_pts[-1] + 1, dtype=np.float64) / 7.0     # the daily grid
        self.member_seeds = [seed + num for num in mix["members"]]
        build = functools.partial(UDEForecaster.build, **model_kwargs(cfg), fused_train=True,
                                  fused_stats=True, device=device)
        bayes = family(cfg)[1]
        self.pop = PopulationTrainer(build, len(mix["members"]), TRAINING_INFO[cfg["family"]],
                                     lr=mix["lr"], len_tr=mix["len_tr"], seed=seed,
                                     member_seeds=self.member_seeds,
                                     ode_kl_w=cfg["loss"]["ode_kl_w"] if bayes else None)
        self.flats = [inputs.weights(cfg, inputs.torch_seed(seed, 6, num), device)
                      for num in mix["members"]]
        for tr, flat in zip(self.pop.members, self.flats):
            inputs.load_weights(tr.model, cfg, flat)
        self.feed = Feed(self.x, self.y, mix["batch"], np.random.default_rng([seed, 7]))
        self.order = self.feed.rng.permutation(len(self.x))

    def epoch(self, rows=None) -> int:
        """One epoch (of ``rows``, else of every window); member-steps run."""
        if rows is not None:
            self.feed.plan = [rows]
        self.pop.train(self.feed, self.t, 1, self.eval_pts, n_samples=self.mix["samples"],
                       grad_lim=self.mix["grad_lim"])
        n = len(rows) if rows is not None else len(self.x)
        return len(self.pop.members) * -(-n // self.mix["batch"])

    def epoch_batches(self) -> List[int]:
        """The windows of each member-step of a whole epoch."""
        B, n = self.mix["batch"], len(self.x)
        rows = [min(B, n - b * B) for b in range(-(-n // B))]
        return [r for r in rows for _ in self.pop.members]

    def leaves(self, tr, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``flat``, laid out as ``tr``'s optimizer lays out its parameters,
        by the parameters' names."""
        return {name: flat[tr.opt.offset(p):tr.opt.offset(p) + p.numel()].view_as(p).clone()
                for name, p in tr.model.named_parameters()}

    def set_up(self) -> List[Dict]:
        """The checked steps, then the warm-up; returns the program's readings."""
        B, n = self.mix["batch"], self.mix["check_steps"]
        b1 = self.cfg["adam"]["b1"]
        self.epoch(self.order[:B])
        grads = [self.leaves(tr, tr.opt.mu / (1.0 - b1)) for tr in self.pop.members]
        self.epoch(self.order[B:n * B])
        readings = []
        for tr, flat, g in zip(self.pop.members, self.flats, grads):
            start = unflatten(flat, param_specs(self.cfg))
            now = self.leaves(tr, tr.opt.flat)
            losses = [b["loss"] for epoch in tr.history.batch_history for b in epoch]
            readings.append({"losses": losses[:n], "first_grad": g,
                             "change": {k: now[k] - start[k] for k in now}})
        tail = len(self.x) % B or B
        warm = self.order[n * B:n * B + B + tail]
        while len(self.pop.members[0].history.epoch_history) <= 4:
            self.epoch(warm)
        return readings

    def reference(self, fault=None, prec: str = "float64") -> List[Dict]:
        """The reference's readings of the checked steps, member by member."""
        cfg, mix = self.cfg, self.mix
        B, n, S = mix["batch"], mix["check_steps"], mix["samples"]
        R, L = cfg["n_regions"], cfg["latent_dim"]
        job = {"lr": mix["lr"], "grad_lim": mix["grad_lim"], "len_tr": mix["len_tr"],
               "points": self.K, "dt": 1.0}
        out = []
        for seed, flat in zip(self.member_seeds, self.flats):
            g = torch.Generator(device=self.device).manual_seed(seed)
            batches = []
            for j in range(n):
                rows = self.order[j * B:(j + 1) * B]
                eps = torch.randn(S, len(rows), R, L - 1, generator=g, device=self.device)
                batches.append((torch.from_numpy(self.x[rows]).to(self.device),
                                torch.from_numpy(self.y[rows][:, self.eval_pts]).to(self.device),
                                eps))
            p0 = unflatten(flat, param_specs(cfg))
            r = ref_train.run_steps(p0, cfg, job, batches, prec, epochs=[0] + [1] * (n - 1),
                                    fault=fault)
            change = {k: r["params"][k] - p0[k].to(r["params"][k].dtype) for k in p0}
            out.append({"losses": r["losses"], "first_grad": r["first_grad"], "change": change})
        return out


def run(cell, seed: int, seconds: float, traced: bool, device, clock) -> Dict:
    job = Population(cell, seed, device)
    readings = job.set_up()
    sync(device)
    start = time.perf_counter()
    setup_s = start - clock
    steps = 0
    while time.perf_counter() - start < seconds:
        steps += job.epoch()
    sync(device)
    window_s = time.perf_counter() - start
    out = {"attempted": steps, "failed": 0,
           "e2e": {"setup_s": setup_s, "train_step_ms": window_s / steps * 1e3},
           "unit_s": window_s / steps, "points": job.K,
           "steps_in": job.mix["window_days"] + job.mix["lag_days"]}
    if traced:
        out["trace"] = trace_stretch(cell, job, device)
    out["memory_peak_bytes"] = peak_memory(device)
    job.pop = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.plain_math()
    out["numbers"] = checks.train_numbers(readings, job.reference())
    return out


def trace_stretch(cell, job: Population, device):
    from benchmark.forecast import metric_entries
    from benchmark.trace import EntryPoints, Trace, profiler
    from torch.autograd.profiler import record_function
    entries = [e for m in cell.per_layer for e in metric_entries(m["name"])]
    with EntryPoints(entries), profiler() as prof:
        for _ in range(cell.traffic["trace_epochs"]):
            with record_function("bench.epoch"):
                job.epoch()
        sync(device)
    return {"trace": Trace(prof), "batches": job.epoch_batches() * cell.traffic["trace_epochs"],
            "span": "bench.epoch"}
