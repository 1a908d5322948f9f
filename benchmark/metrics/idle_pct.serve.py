"""Share of the traced stretch of forecast requests in which no kernel ran
on the card, from the profiler's kernel intervals.  The copies (the window
up, the forecast down) count as idle: no kernel runs while they move.  It
should move ``forecast_p95_ms``."""


def read(ctx):
    if ctx.traffic["kind"] != "forecast":
        return None
    busy = ctx.trace.busy(ctx.lo, ctx.hi, copies=False)
    return 100.0 * (1.0 - busy / (ctx.hi - ctx.lo))
