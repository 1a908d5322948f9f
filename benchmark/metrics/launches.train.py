"""Kernel launches the host makes a member-step: the CUDA runtime's launch
calls inside the program's ``PopulationTrainer.epoch`` spans, over the
member-steps traced.  A CUDA graph of the step would show here first.  It
should move ``train_step_ms``."""

SPAN = "PopulationTrainer.epoch"


def read(ctx):
    n = ctx.trace.launches_in(SPAN)
    if not n or not ctx.units:
        return None
    return n / ctx.units
