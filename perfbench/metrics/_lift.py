"""Shared by the lift's roofline readers: the traced steps' work counts."""

from perfbench import flops


def steps(ctx):
    """[(sizes, counts of the step's keyframes)] for every traced step."""
    z = flops.lift_sizes(ctx["cfg"], ctx["traffic"], ctx["traffic"]["batch_size"])
    work = ctx["work"]
    return [(z, {k: v[idx] for k, v in work.items()})
            for idx in ctx["probe"].traced.get("step_pool", [])]
