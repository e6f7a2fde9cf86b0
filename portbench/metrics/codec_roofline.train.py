"""The int8 codec kernels' share of their bytes bound: each bucket's
encode, decode of the gathered codes and fused add (each input byte read
once, each output byte written once, at 3.35 TB/s), over the device time
of those launches in the traced steps.  Nothing is read where the mix is
not int8 or the launches are not one of each kind a bucket and step."""
from portbench.counts import bounds, buckets

KINDS = ("quantize_int8_kernel", "dequantize_int8_kernel", "fused_add")


def read(ctx):
    comm = ctx.cell.traffic["comm"]
    if comm["compression"] != "int8":
        return None
    plan = buckets.bucket_elements(ctx.leaf_sizes, ctx.itemsize, comm["fusion_buffer_mb"])
    times = [ctx.trace.kernels_named(kind) for kind in KINDS]
    if any(len(t) != len(plan) * ctx.trace.steps for t in times):
        return None
    k = ctx.world
    bound = sum(bounds.quantize_bound_s(rows) + bounds.dequantize_bound_s(k * rows)
                + bounds.fused_add_bound_s(k, n) for n, rows in plan)
    return 100.0 * bound * ctx.trace.steps / sum(sum(t) for t in times)
