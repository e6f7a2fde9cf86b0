"""The whole step's share of the card's peak in the configuration's dtype
(``counts.bounds.PEAK_FLOPS``): model FLOPs of the traced steps (3 x
forward, causal attention at S/2, MoE at its active experts, no recompute;
``counts.flops``) over the traced window, a card."""
from portbench.counts import bounds, flops


def read(ctx):
    t = ctx.cell.traffic
    done = flops.step_flops(ctx.cell.arch, t["batch"], t["seq_len"]) * ctx.trace.steps
    return 100.0 * done / ctx.world / ctx.trace.window_s / bounds.PEAK_FLOPS[ctx.cell.arch.dtype]
