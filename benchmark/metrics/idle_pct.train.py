"""Share of the population's epochs in which no kernel ran on the card:
inside the program's own ``PopulationTrainer.epoch`` spans, from the
profiler's kernel intervals.  It should move ``train_step_ms``."""

SPAN = "PopulationTrainer.epoch"


def read(ctx):
    spans = ctx.trace.spans.get(SPAN)
    if not spans:
        return None
    total = sum(e - s for s, e in spans)
    busy = sum(ctx.trace.busy(s, e, copies=False) for s, e in spans)
    return 100.0 * (1.0 - busy / total)
