"""Traffic of kind ``forecast``: a closed loop of forecast requests.

``clients`` callers (one: the sweeps' test forecast and a forecaster's weekly
run both wait for each forecast before they ask for the next) each send a
request of ``windows`` surveillance windows from the host with ``samples``
Monte-Carlo draws a window; the program answers with the (B, S, T, R)
forecast over the daily grid of ``window + horizon + 1`` points, and the
request ends when that forecast is in host memory, where the caller reads it.
The mix's ``handoff`` says how it gets there: ``"cpu"``, a fresh pageable
tensor a request, ``y.cpu()``, as the port's own caller takes it
(``parallel/sweep.py``); or ``"pinned"``, a copy into page-locked buffers
that the caller allocates once and reuses (a hypothetical caller: no code of
the port keeps such buffers).
The windows and draws come from a pool of ``pool`` requests made in set-up,
cycled in order; a Bayes family's weight-noise seed is drawn afresh for every
request.  The entry is the serving class of the configuration's family,
built once in set-up: ``FusedForecaster`` or ``FusedBayesForecaster``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import checks, inputs
from benchmark.reference import model as ref
from benchmark.reference.params import family, param_specs, unflatten


class Requests:
    """The pool of requests and the program's serving object."""

    def __init__(self, cell, seed: int, device):
        from fiude_tpu_torch.models.vae import UDEForecaster
        from fiude_tpu_torch.ops.fused_bayes import FusedBayesForecaster
        from fiude_tpu_torch.ops.fused_ude import FusedForecaster

        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.device = cfg, mix, device
        self.bayes = family(cfg)[1]
        self.flat = inputs.weights(cfg, inputs.torch_seed(seed, 1), device)
        model = UDEForecaster.build(**model_kwargs(cfg), device=device)
        inputs.load_weights(model, cfg, self.flat)
        serving = FusedBayesForecaster if self.bayes else FusedForecaster
        self.forecaster = serving(model, fa_w=cfg["fa_w"])
        rng = np.random.default_rng([seed, 2])
        B, S = mix["windows"], mix["samples"]
        self.x = [torch.from_numpy(inputs.windows(rng, B, cfg, mix, with_targets=False)[0])
                  for _ in range(mix["pool"])]
        g = torch.Generator(device=device).manual_seed(inputs.torch_seed(seed, 3))
        self.eps = torch.randn((mix["pool"], S, B, cfg["n_regions"], cfg["latent_dim"] - 1),
                               generator=g, device=device)
        self.noise = np.random.default_rng([seed, 4])
        self.T = inputs.daily_points(mix)
        self.t = np.arange(self.T, dtype=np.float64) / 7.0
        self.seeds: Dict[int, int] = {}
        self.trajectories = B * S
        if mix["handoff"] not in ("cpu", "pinned"):
            raise ValueError(f"unknown handoff {mix['handoff']!r}")
        self.pinned = mix["handoff"] == "pinned"
        self.spare: List[torch.Tensor] = []      # the caller's host buffers not in use
        self.buffer = None

    def __call__(self, i: int) -> torch.Tensor:
        """Request ``i``: its forecast, in host memory."""
        k = i % len(self.x)
        x = self.x[k].to(self.device)
        if self.bayes:
            seed = int(self.noise.integers(0, 2 ** 31 - 1))
            self.seeds[i] = seed
            y = self.forecaster(x, self.t, self.eps[k], seed=seed)
        else:
            y = self.forecaster(x, self.t, self.eps[k])
        if not self.pinned:
            self.buffer = y.cpu()
            return self.buffer
        if self.buffer is None:           # the first (warm-up) request lays them out
            pinned = self.device.type == "cuda"
            self.spare = [torch.empty_strided(y.shape, y.stride(), pin_memory=pinned)
                          for _ in range(self.mix["check_requests"] + 2)]
            self.buffer = self.spare.pop()
        self.buffer.copy_(y)             # returns once the forecast is on the host
        return self.buffer

    def keep(self) -> torch.Tensor:
        """Hand the current answer over (it is kept); a pinned caller takes a
        spare buffer for the next."""
        kept = self.buffer
        self.buffer = self.spare.pop() if self.pinned else None
        return kept

    def release(self, buffer: torch.Tensor) -> None:
        if self.pinned:
            self.spare.append(buffer)

    def free(self):
        self.forecaster = None


def model_kwargs(cfg: Dict) -> Dict:
    """The configuration as the program's ``UDEForecaster.build`` takes it."""
    enc = cfg["encoder"]
    return dict(n_regions=cfg["n_regions"], latent_dim=cfg["latent_dim"], n_qs=cfg["n_qs"],
                ode_name=cfg["family"], encoder_name=enc["kind"],
                enc_params={"q_sizes": tuple(enc["q_sizes"]), "ff_sizes": tuple(enc["ff_sizes"]),
                            "SIR_scaler": list(enc["SIR_scaler"])},
                ode_params=dict(cfg["ode"]), dec_params={}, ic_jitter=cfg["ic_jitter"])


def run(cell, seed: int, seconds: float, traced: bool, device, clock) -> Dict:
    """Set up, warm up, measure ``seconds`` of requests, optionally trace a
    stretch, then check sampled answers against the reference."""
    mix = cell.traffic
    if mix["clients"] != 1:
        raise ValueError("a forecast mix here has one client, waiting for each answer")
    entered = time.perf_counter()
    req = Requests(cell, seed, device)
    sync(device)
    built = time.perf_counter()
    for i in range(mix["warmup_requests"]):
        req(-1 - i)
    sync(device)
    start = time.perf_counter()
    setup_s = start - clock
    # where set-up went: the interpreter, torch and the CUDA runtime; the
    # weights, model, serving object and pool; the warm-up requests
    stages = {"start_s": entered - clock, "build_s": built - entered, "warmup_s": start - built}
    pick = np.random.default_rng([seed, 9])
    kept, latencies = {}, []
    i = 0
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        req(i)
        latencies.append(time.perf_counter() - t0)
        reservoir(kept, i, req, mix["check_requests"], pick)
        i += 1
    window_s = time.perf_counter() - start
    n = len(latencies)
    out = {"attempted": n, "failed": 0,
           "e2e": {"setup_s": setup_s,
                   "forecast_p95_ms": float(np.percentile(np.asarray(latencies), 95)) * 1e3,
                   "forecast_traj_per_s": n * req.trajectories / window_s},
           "setup_stages": stages, "unit_s": window_s / n, "points": req.T,
           "steps_in": mix["window_days"] + mix["lag_days"]}
    if traced:
        out["trace"] = trace_stretch(cell, req, n, device)
    out["memory_peak_bytes"] = peak_memory(device)
    out["numbers"] = check(cell, req, kept)
    return out


def trace_stretch(cell, req: Requests, first: int, device):
    from benchmark.trace import EntryPoints, Trace, profiler
    from torch.autograd.profiler import record_function
    entries = [e for m in cell.per_layer for e in metric_entries(m["name"])]
    sync(device)
    with EntryPoints(entries), profiler() as prof:
        for k in range(cell.traffic["trace_requests"]):
            with record_function("bench.request"):
                req(first + k)
        sync(device)
    n = cell.traffic["trace_requests"]
    return {"trace": Trace(prof), "batches": [cell.traffic["windows"]] * n,
            "span": "bench.request"}


def metric_entries(name: str):
    from benchmark.spec import metric_module
    return getattr(metric_module(name), "ENTRY_POINTS", [])


def reservoir(kept: Dict, i: int, req: Requests, k: int, rng) -> None:
    """Keep a uniform sample of ``k`` of the answers, drawn from the seed,
    by handing buffers over (no copy)."""
    if len(kept) < k:
        kept[i] = req.keep()
        return
    j = int(rng.integers(0, i + 1))
    if j < k:
        req.release(kept.pop(sorted(kept)[j]))
        kept[i] = req.keep()


def check(cell, req: Requests, kept: Dict) -> Dict[str, float]:
    """The sampled answers against the float64 reference, computed after the
    program's state is freed."""
    req.free()
    if req.device.type == "cuda":
        torch.cuda.empty_cache()
    ref.plain_math()
    p = ref.cast(unflatten(req.flat, param_specs(req.cfg)), "float64")
    errors = []
    for i, y in sorted(kept.items()):
        k = i % len(req.x)
        y_ref = ref.forecast(p, req.cfg, req.x[k].to(req.device, torch.float64),
                             req.eps[k].double(), req.T, 1.0 / 7.0, "float64",
                             noise_seed=req.seeds.get(i))
        errors.append(checks.trajectory_errors(y.to(req.device), y_ref))
    return checks.serve_numbers(errors)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
