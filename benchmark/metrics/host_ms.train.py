"""The host's ms a member-step inside the program's own ``train.step``
spans (``Trainer._device_step``: the step's enqueue, loss, backward and
Adam), over the member-steps traced.  The step's phases are its child spans
``train.loss``, ``train.backward`` and ``train.adam``.  It should move
``train_step_ms``."""

SPAN = "train.step"


def read(ctx):
    spans = ctx.trace.spans.get(SPAN)
    if not spans or not ctx.units:
        return None
    return sum(e - s for s, e in spans) / 1e6 / ctx.units
