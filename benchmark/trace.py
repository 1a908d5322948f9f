"""The traced run's instruments: spans around the program's layer entry
points, and the reduction of a ``torch.profiler`` trace to what the
per-layer metrics read.

:class:`EntryPoints` replaces each entry point (``"module:attr[.attr]"``) for
the traced stretch only by a wrapper that runs it inside a ``record_function``
span named ``fwd:<entry>`` and then finds the autograd nodes the call created
(those reachable from its outputs and not from its inputs): each of them runs
its backward inside a ``bwd:<entry>`` span, opened and closed by the node's
own pre- and post-hooks.  A kernel belongs to a span when the runtime call
that launched it lies inside it (the kernel and its launch share a CUPTI
correlation id).

:class:`Trace` keeps, from the profiler's raw events: every kernel (device
interval, name, the launch's host time), every copy and memset (device
interval), every kernel launch call (host time), the program's and the
benchmark's user spans, and the host's operators, which say what the host
was doing while the device sat idle.
"""

from __future__ import annotations

import bisect
import importlib
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

FWD, BWD = "fwd:", "bwd:"


def _resolve(entry: str):
    module_name, _, path = entry.partition(":")
    owner = importlib.import_module(module_name)
    parts = path.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    return owner, parts[-1]


def _tensors(obj) -> Iterable[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class EntryPoints:
    """Spans around ``entries`` while the context is open."""

    def __init__(self, entries: Iterable[str]):
        self.entries = sorted(set(entries))
        self.saved: List[Tuple[object, str, object]] = []
        self.open: Dict[Tuple[int, str], object] = {}

    def _hook(self, node, name: str):
        key = (id(node), name)

        def pre(grad_outputs):
            rf = record_function(name)
            rf.__enter__()
            self.open[key] = rf

        def post(grad_inputs, grad_outputs):
            rf = self.open.pop(key, None)
            if rf is not None:
                rf.__exit__(None, None, None)

        node.register_prehook(pre)
        node.register_hook(post)

    def _wrap(self, fn, entry: str):
        def wrapped(*args, **kwargs):
            with record_function(FWD + entry):
                out = fn(*args, **kwargs)
            # node objects are held while the walk runs, so that their ids,
            # which the sets compare, stay theirs
            held = [t.grad_fn for t in _tensors((args, kwargs)) if t.grad_fn is not None]
            before = {id(n) for n in held}
            todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
            seen = set()
            while todo:
                node = todo.pop()
                if node is None or id(node) in seen or id(node) in before:
                    continue
                held.append(node)
                seen.add(id(node))
                if type(node).__name__ == "AccumulateGrad":
                    continue
                self._hook(node, BWD + entry)
                todo.extend(nf for nf, _ in node.next_functions)
            return out
        if hasattr(fn, "__dict__"):
            wrapped.__dict__ = fn.__dict__     # a function's own counters stay its own
        return wrapped

    def __enter__(self):
        for entry in self.entries:
            owner, attr = _resolve(entry)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, entry))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved.clear()
        return False


_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def kind_of(e) -> str:
    """The kind of a raw profiler event: ``kernel``, ``gpu_memcpy``,
    ``gpu_memset``, ``gpu_user_annotation``, ``cuda_runtime``,
    ``user_annotation`` or ``cpu_op`` (from the event itself where the
    installed torch says, else from its device, flags and name)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def short_name(name: str, width: int = 150) -> str:
    """A kernel's name without its parameter list, cut to ``width``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width]


def union_length(intervals: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` inside [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Trace:
    """The profiler's raw events reduced to what the metrics read; times in ns."""

    def __init__(self, prof):
        runtime: Dict[int, int] = {}
        raw = []
        self.launches: List[int] = []
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.host_ops: List[Tuple[int, int, str]] = []
        self.copies: List[Tuple[int, int, str]] = []
        for e in prof.profiler.kineto_results.events():
            kind = kind_of(e)
            if kind == "kernel":
                raw.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                            e.correlation_id(), e.linked_correlation_id()))
            elif kind in ("gpu_memcpy", "gpu_memset"):
                self.copies.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif kind in ("cuda_runtime", "cuda_driver"):
                runtime[e.correlation_id()] = e.start_ns()
                if "Launch" in e.name():
                    self.launches.append(e.start_ns())
            elif kind == "user_annotation":
                self.spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
                self.host_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif kind == "cpu_op":
                self.host_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        self.kernels: List[Tuple[int, int, str, Optional[int]]] = []
        for s, t, name, corr, linked in raw:
            launch = runtime.get(corr, runtime.get(linked))
            self.kernels.append((s, t, name, launch))
        self.kernels.sort()
        self.launches.sort()
        self.host_ops.sort()
        self.unmatched = sum(k[3] is None for k in self.kernels)

    def stretch(self, name: str) -> Tuple[int, int]:
        """The first and last instant of the spans named ``name``."""
        spans = self.spans.get(name, [])
        if not spans:
            raise RuntimeError(f"the trace holds no span {name!r}")
        return min(s for s, _ in spans), max(e for _, e in spans)

    def kernel_time(self, span: str) -> Tuple[int, int]:
        """(device ns, kernels) of the kernels launched inside the spans
        named ``span``."""
        spans = sorted(self.spans.get(span, []))
        starts = [s for s, _ in spans]
        total = count = 0
        for s, t, _, launch in self.kernels:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += t - s
                count += 1
        return total, count

    def busy(self, lo: int, hi: int, copies: bool) -> int:
        """Device ns in [lo, hi) with a kernel (or, with ``copies``, also a
        copy or memset) running."""
        iv = [(s, t) for s, t, *_ in self.kernels]
        if copies:
            iv += [(s, t) for s, t, _ in self.copies]
        return union_length(iv, lo, hi)

    def launches_in(self, span: str) -> int:
        n = 0
        for s, e in self.spans.get(span, []):
            n += bisect.bisect_right(self.launches, e) - bisect.bisect_left(self.launches, s)
        return n

    def device_ops(self, lo: int, hi: int, top: int = 10) -> List[List]:
        """The device operations that took most time in [lo, hi), seconds."""
        by = defaultdict(int)
        for s, t, name, *_ in self.kernels:
            if lo <= s < hi:
                by[short_name(name)] += t - s
        for s, t, name in self.copies:
            if lo <= s < hi:
                by[name] += t - s
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t: int, limit: int = 4000) -> str:
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), "")) - 1
        for j in range(i, max(i - limit, -1), -1):
            s, e, name = self.host_ops[j]
            if e >= t:
                return name
        return "host outside any operator"

    def idle_gaps(self, lo: int, hi: int, top: int = 10) -> List[List]:
        """The device's idle gaps in [lo, hi), summed by the innermost host
        operator running at each gap's start: the ``top`` largest, seconds."""
        iv = sorted((s, t) for s, t, *_ in self.kernels + self.copies if t > lo and s < hi)
        gaps, cur = [], lo
        for s, t in iv:
            if s > cur:
                gaps.append((s - cur, cur))
            cur = max(cur, t)
        if hi > cur:
            gaps.append((hi - cur, cur))
        gaps.sort(reverse=True)
        by = defaultdict(int)
        for length, start in gaps[:400]:
            by[self._host_at(start)] += length
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
