"""Per-layer FLOP shares for the measured gradient timeline.

Counterpart of ``layer_breakdown_from_params`` in ``repro/core/flops.py``;
the analytic model of that module (``layer_breakdown``) is not ported yet.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from repro_torch.utils.tree import tree_leaves

Layer = Tuple[str, int, float]    # (name, params, fwd_flops)


def layer_breakdown_from_params(params: Any, cfg=None) -> List[Layer]:
    """Chunk a parameter tree into its top-level entries, in the tree's own
    key order, with FLOPs proportional to the parameter count."""
    out: List[Layer] = []
    for key, sub in params.items():
        n = sum(int(p.numel()) for p in tree_leaves(sub))
        out.append((key, n, float(n)))
    return out
