"""Timing and tracing on the card (counterpart of ``fiude_tpu/utils/profiler.py``).

* :func:`time_fn` — steady-state latency of a callable, each repetition
  closed by ``torch.cuda.synchronize()`` when CUDA is in use (PyTorch returns
  before the device finishes);
* :func:`throughput_fn` — calls a second with the calls queued back to back
  and one synchronise at the end;
* :func:`param_count` — a module's parameter count;
* :func:`trace` — a ``torch.profiler`` context over the CPU and, when there
  is one, the card;
* :func:`host_syncs` — the synchronising CUDA runtime calls and the
  device-to-host copies in such a trace;
* :func:`span` — the program's own ``record_function`` span, recorded only
  while a profiler records.

The program's spans, each tied to its request or step by nesting in time on
the calling thread:

* ``serve.request`` — a forecaster's whole call: the grid check, encode,
  reparam, trajectory and the (B, S, T, R) reshape; inside it
  ``serve.encode`` (the encoder: K1 and its input projection) and
  ``serve.trajectory`` (K2, or the weight draw and K7);
* ``train.step`` — one step's or member-step's enqueue
  (``Trainer._device_step``); inside it ``train.loss`` (the forward and the
  loss), ``train.backward`` and ``train.adam`` (the grad norm, the skip rule
  and Adam's step);
* ``Trainer.epoch``, ``PopulationTrainer.epoch`` — an epoch of steps.
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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records, so
    that the span shares the device trace's clock; else one shared no-op
    context, which costs a check of the profiler's state and nothing more."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
