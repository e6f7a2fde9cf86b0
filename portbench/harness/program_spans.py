"""What the program's own tracer (``repro_torch.utils.trace``) recorded in
the traced run, for the metrics that read it.

The tracer records while a ``torch.profiler`` profile runs, so it holds
the cell's ``trace_steps`` steps profiled on the device alone and then the
one step profiled with host operations.  Only the first ``ctx.trace.steps``
``step`` spans and the spans inside them are kept: the last step is left
out.  A program without the tracer, or whose spans did not fire, gives
``None``; nothing here raises for that.
"""
from __future__ import annotations

from typing import Optional


def steps(ctx) -> Optional[tuple]:
    """(the kept ``step`` records, every record inside them), or None."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    recs = sorted(trace.records(), key=lambda r: r.id)
    kept = [r for r in recs if r.name == trace.STEP][:ctx.trace.steps]
    if len(kept) < ctx.trace.steps:
        return None
    ids = {r.id for r in kept}
    return kept, [r for r in recs if r.step in ids and r.name != trace.STEP]


def ms_a_step(ctx, *names: str) -> Optional[float]:
    """Device ms a kept step of the spans named ``names``, summed; None
    where none of them fired."""
    found = steps(ctx)
    if found is None:
        return None
    times = [r.ms for r in found[1] if r.name in names]
    return sum(times) / ctx.trace.steps if times else None


def count_a_step(ctx, name: str) -> Optional[float]:
    """A counter's change over a kept step, averaged; None where it did not
    change."""
    found = steps(ctx)
    if found is None:
        return None
    deltas = [r.attrs.get("counts", {}).get(name, 0) for r in found[0]]
    return sum(deltas) / ctx.trace.steps if any(deltas) else None
