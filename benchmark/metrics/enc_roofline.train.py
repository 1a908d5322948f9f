"""The encoder's share of its roofline in a member-step: the Back-GRU's
forward (K3) and its backward through time (K4).

The least time is the larger of the layer's operations over the card's
float32 peak and its bytes over the peak bandwidth, counted from the shapes
by ``work.encoder_train`` for every member-step traced; the time is the
device time of every kernel that the entry points below launched, forward and
the backward of the autograd nodes they made.  It should move
``train_step_ms``."""

ENTRY_POINTS = ["fiude_tpu_torch.ops.fused_gru_train:encode_train"]


def read(ctx):
    from benchmark.trace import BWD, FWD
    device_ns = sum(ctx.trace.kernel_time(FWD + e)[0] + ctx.trace.kernel_time(BWD + e)[0]
                    for e in ENTRY_POINTS)
    if not device_ns:
        return None
    least = sum(ctx.work.least_seconds(ctx.work.encoder_train(ctx.config, rows, ctx.steps_in),
                                       ctx.peak) for rows in ctx.batches)
    return 100.0 * least / (device_ns / 1e9)
