#!/usr/bin/env python3
"""The cost of one program span (``fiude_tpu_torch.utils.profiler.span``)
with the profiler off and on, beside an empty ``nullcontext`` loop and an
ungated ``torch.profiler.record_function``.

    python3 scripts/port_span_cost.py

Three repeats; prints one line ``SPAN_COST {json}`` of us a span:
``off_us`` and ``on_us`` net of the empty loop, ``off_total_us`` the whole
``with`` statement, ``ungated_off_us`` a ``record_function`` with no
profiler.  The profiler traces the card too when CUDA is there."""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from fiude_tpu_torch.utils.profiler import span  # noqa: E402


def loop(n, make):
    t0 = time.perf_counter()
    for _ in range(n):
        with make("serve.request"):
            pass
    return time.perf_counter() - t0


def main():
    null = contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {}
    for _ in range(3):
        n, m = 1_000_000, 20_000
        empty = loop(n, lambda name: null)
        off = loop(n, span)
        ungated = loop(200_000, torch.profiler.record_function) / 200_000
        with torch.profiler.profile(activities=acts):
            empty_on = loop(m, lambda name: null)
            on = loop(m, span)
        out.setdefault("off_us", []).append((off - empty) / n * 1e6)
        out.setdefault("off_total_us", []).append(off / n * 1e6)
        out.setdefault("on_us", []).append((on - empty_on) / m * 1e6)
        out.setdefault("ungated_off_us", []).append(ungated * 1e6 - empty / n * 1e6)
    print("SPAN_COST " + json.dumps(out))


if __name__ == "__main__":
    main()
