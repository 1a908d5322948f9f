"""A whole member-step's share of the card's peak, forward and backward.

The model's operations are counted from the shapes by ``work.step_flops``; the
time is the untraced window's, member-step by member-step, against the card's float32
peak outside the tensor cores.  It should move ``train_step_ms``."""


def read(ctx):
    if ctx.traffic["kind"] != "population":
        return None
    flops = sum(ctx.work.step_flops(ctx.config, rows, ctx.steps_in, ctx.traffic["samples"],
                              ctx.points) for rows in ctx.batches) / len(ctx.batches)
    return 100.0 * flops / (ctx.unit_s * ctx.peak["float32_flops"])
