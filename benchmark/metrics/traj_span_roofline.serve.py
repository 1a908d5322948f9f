"""The trajectory layer's share of its roofline in a forecast request, read
from the program's own ``serve.trajectory`` span: K2, or the weight draw and
K7.  The twin of ``traj_roofline.serve``, whose kernels are those of the
benchmark's wrapper around the entry point.

The least time is the larger of the layer's operations over the card's
float32 peak and its bytes over the peak bandwidth, counted from the shapes
by ``work.trajectory_serve`` for every request traced; the time is the
device time of every kernel launched inside the span.  It should move
``forecast_traj_per_s``."""

SPAN = "serve.trajectory"


def read(ctx):
    device_ns, _ = ctx.trace.kernel_time(SPAN)
    if not device_ns:
        return None
    least = sum(ctx.work.least_seconds(
        ctx.work.trajectory_serve(ctx.config, rows * ctx.traffic["samples"], ctx.points),
        ctx.peak) for rows in ctx.batches)
    return 100.0 * least / (device_ns / 1e9)
