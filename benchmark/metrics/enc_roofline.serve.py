"""The encoder's share of its roofline in a forecast request: the Back-GRU
and its head (K1).

The least time is the larger of the layer's operations over the card's
float32 peak and its bytes over the peak bandwidth, counted from the shapes
by ``work.encoder_serve`` for every request traced; the time is the
device time of every kernel that the entry points below launched.  It should
move ``forecast_traj_per_s``."""

ENTRY_POINTS = ["fiude_tpu_torch.ops.fused_gru:FusedBackGRUEncoder.__call__"]


def read(ctx):
    from benchmark.trace import BWD, FWD
    device_ns = sum(ctx.trace.kernel_time(FWD + e)[0] + ctx.trace.kernel_time(BWD + e)[0]
                    for e in ENTRY_POINTS)
    if not device_ns:
        return None
    least = sum(ctx.work.least_seconds(ctx.work.encoder_serve(ctx.config, rows, ctx.steps_in),
                                       ctx.peak) for rows in ctx.batches)
    return 100.0 * least / (device_ns / 1e9)
