"""The flash-attention kernel's share of its roofline: the bound of every
launch in the traced steps (forward and remat recompute; causal FLOPs at
what the inputs need; at the peak of the configuration's dtype;
``counts.bounds``) over their device time."""
from portbench.counts import bounds


def read(ctx):
    times = ctx.trace.kernels_named("flash_fwd")
    if not times:
        return None
    a, t = ctx.cell.arch, ctx.cell.traffic
    rows = t["batch"] // ctx.world if t["batch"] % ctx.world == 0 else t["batch"]
    bound = bounds.flash_bound_s(rows, a.n_heads, a.n_kv_heads, t["seq_len"], a.head_dim, a.dtype)
    return 100.0 * bound * len(times) / sum(times)
