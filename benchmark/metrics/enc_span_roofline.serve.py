"""The encoder's share of its roofline in a forecast request, read from the
program's own ``serve.encode`` span: the Back-GRU and its head (K1) with its
input projection.  The twin of ``enc_roofline.serve``, whose kernels are
those of the benchmark's wrapper around the entry point.

The least time is the larger of the layer's operations over the card's
float32 peak and its bytes over the peak bandwidth, counted from the shapes
by ``work.encoder_serve`` for every request traced; the time is the device
time of every kernel launched inside the span.  It should move
``forecast_traj_per_s``."""

SPAN = "serve.encode"


def read(ctx):
    device_ns, _ = ctx.trace.kernel_time(SPAN)
    if not device_ns:
        return None
    least = sum(ctx.work.least_seconds(ctx.work.encoder_serve(ctx.config, rows, ctx.steps_in),
                                       ctx.peak) for rows in ctx.batches)
    return 100.0 * least / (device_ns / 1e9)
