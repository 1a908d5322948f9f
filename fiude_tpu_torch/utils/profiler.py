"""Timing and tracing on the card (counterpart of ``fiude_tpu/utils/profiler.py``).

* :func:`time_fn` — steady-state latency of a callable, each repetition
  closed by ``torch.cuda.synchronize()`` when CUDA is in use (PyTorch returns
  before the device finishes);
* :func:`throughput_fn` — calls a second with the calls queued back to back
  and one synchronise at the end;
* :func:`solves_per_sec` — region x ensemble UDE trajectory solves a second;
* :func:`param_count` — a module's parameter count;
* :func:`trace` — a ``torch.profiler`` context over the CPU and, when there
  is one, the card;
* :func:`host_syncs` — the synchronising CUDA runtime calls and the
  device-to-host copies in such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

#: CUDA runtime calls that make the host wait for the device.  ``.cpu()`` of
#: a device tensor and ``.to("cuda")`` from pageable memory each end in a
#: ``cudaStreamSynchronize``.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, reps: int = 20, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Latency of ``fn(*args, **kwargs)`` in seconds: mean, min, median, max
    over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - start)
    t = np.asarray(times)
    return {"mean": float(t.mean()), "min": float(t.min()),
            "p50": float(np.median(t)), "max": float(t.max())}


def throughput_fn(fn: Callable, *args, reps: int = 20, warmup: int = 2, **kwargs) -> float:
    """Calls a second: ``reps`` calls queued, then one synchronise, as a
    training loop overlaps its launches with the device's work."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    start = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kwargs)
    _sync()
    return reps / (time.perf_counter() - start)


def solves_per_sec(forward: Callable, *args, n_samples: int, batch: int, n_regions: int,
                   reps: int = 20) -> float:
    """Region x ensemble UDE solves a second for a whole-forward callable."""
    return throughput_fn(forward, *args, reps=reps) * n_samples * batch * n_regions


def param_count(module: nn.Module) -> int:
    """The number of parameters of ``module``."""
    return int(sum(p.numel() for p in module.parameters()))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` context over the CPU and the card (when CUDA is
    available); yields the profiler.  With ``log_dir`` the trace is written
    there as ``trace.json`` (Chrome's format) on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def host_syncs(events, start_us: float = float("-inf"), end_us: float = float("inf")
               ) -> Dict[str, int]:
    """Counts, in the profiler ``events`` that start in [start_us, end_us):
    ``"calls"``, the runtime calls of :data:`SYNC_CALLS`, and ``"dtoh"``, the
    device's device-to-host copies."""
    calls = dtoh = 0
    for e in events:
        if not start_us <= e.time_range.start < end_us:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dtoh += "Memcpy DtoH" in e.name
        else:
            calls += e.name in SYNC_CALLS
    return {"calls": calls, "dtoh": dtoh}
