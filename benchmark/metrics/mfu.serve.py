"""A whole forecast request's share of the card's peak.

The model's operations are counted from the shapes by ``work.request_flops``; the
time is the untraced window's, request by request, against the card's float32
peak outside the tensor cores.  It should move ``forecast_traj_per_s``."""


def read(ctx):
    if ctx.traffic["kind"] != "forecast":
        return None
    flops = sum(ctx.work.request_flops(ctx.config, rows, ctx.steps_in, ctx.traffic["samples"],
                              ctx.points) for rows in ctx.batches) / len(ctx.batches)
    return 100.0 * flops / (ctx.unit_s * ctx.peak["float32_flops"])
