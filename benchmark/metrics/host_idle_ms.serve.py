"""The ms a traced forecast request in which the card runs neither a kernel
nor a copy while the host is inside the program's own ``serve.request``
span (``fiude_tpu_torch/utils/profiler.py``): the idle that the program's
host code causes, from the grid check to the last launch.  The rest of
``idle_pct.serve`` is the caller's: the window's upload, the forecast's
handoff and the loop.  The span shares the device trace's clock.  It should
move ``forecast_p95_ms``.

It is read from the traced run only, and the profiler's own cost for each
operator the program runs falls inside the span: the number is higher than
the idle of an untraced call (``scripts/port_request_idle.py`` measures
that one with CUDA events).  A change to the host's code is judged by
``forecast_p95_ms``, not by this metric alone."""

SPAN = "serve.request"


def read(ctx):
    spans = ctx.trace.spans.get(SPAN)
    if not spans or not ctx.units:
        return None
    idle = sum(e - s - ctx.trace.busy(s, e, copies=True) for s, e in spans)
    return idle / 1e6 / ctx.units
