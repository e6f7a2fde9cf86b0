"""How ``correct`` is decided: the program's first steps against the
reference's, by three numbers, each against its limit in the cell's file.

- ``loss_gap``: the relative gap of the first step's loss.  The later
  steps' losses swing a hundredfold from seed to seed at float32 round-off:
  AdamW's first update is lr * sign(g), and an element whose gradient lies
  within round-off of zero flips it; the later steps are held by
  ``change_gap``;
- ``grad_gap``: the worst leaf's gap between the norms of its first
  gradient as AdamW gets it (the program's read from its first moment
  after one step, m / (1 - b1)), over the larger of the reference's norm
  of that leaf and of the median leaf;
- ``change_gap``: the same for each leaf's change over the steps followed,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (AdamW moves those by round-off alone);
- a leaf that the reference moves by a rule and not by its gradient
  (``Readings.ruled``: a router's correction bias) is left out of
  ``grad_gap`` and its median, on both sides, and always kept in
  ``change_gap`` and its median, whatever its gradient: a wrong rule fails;
- ``grad_gap_median``, ``change_gap_median``: the median leaf's gap of
  each, which is steady from seed to seed where the worst leaf swings: in
  an MoE layer a token whose top-k experts tie to round-off is routed one
  way by the program and the other by the reference, on a few seeds in
  ten, and the router's and the experts' leaves then read tens of times
  their usual gap.

A reading that is not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

ROUND_OFF_ONLY = 1e-3


NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median", "change_gap_median")


def _leaf_gaps(prog: Sequence[float], ref: Sequence[float], keep: Sequence[int]) -> List[float]:
    """Each kept leaf's gap of norms over the larger of the reference's
    norm of that leaf and of the median leaf; not finite -> inf."""
    floor = statistics.median([ref[i] for i in keep])
    gaps = [abs(prog[i] - ref[i]) / max(ref[i], floor) for i in keep]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def _worst(gaps: List[float], keep: Sequence[int], paths: Sequence[str]) -> Tuple[float, str]:
    i = max(range(len(gaps)), key=lambda j: gaps[j])
    return gaps[i], paths[keep[i]]


def gaps(prog, ref) -> Dict[str, Tuple[float, str]]:
    """{number: (reading, where)} of program readings against reference
    readings (``reference.train.Readings`` both)."""
    if list(prog.paths) != list(ref.paths):
        raise ValueError("the program's leaves are not the reference's")
    first = abs(prog.losses[0] - ref.losses[0]) / abs(ref.losses[0])
    loss = (first if math.isfinite(first) else math.inf, "step 1")
    ruled = set(ref.ruled)
    graded = [i for i, k in enumerate(ref.paths) if k not in ruled]
    median_g = statistics.median([ref.grad_norms[i] for i in graded])
    moved = [i for i, k in enumerate(ref.paths)
             if k in ruled or ref.grad_norms[i] >= ROUND_OFF_ONLY * median_g]
    grad = _leaf_gaps(prog.grad_norms, ref.grad_norms, graded)
    change = _leaf_gaps(prog.change_norms, ref.change_norms, moved)
    return {"loss_gap": loss,
            "grad_gap": _worst(grad, graded, ref.paths),
            "change_gap": _worst(change, moved, ref.paths),
            "grad_gap_median": (statistics.median(grad), "median leaf"),
            "change_gap_median": (statistics.median(change), "median leaf")}


def leaf_gaps(prog, ref) -> Dict[str, Dict[str, float]]:
    """Every leaf's gradient and change gap, as ``gaps`` weighs them (for
    the calibration's record)."""
    every = list(range(len(ref.paths)))
    return {name: dict(zip(ref.paths, _leaf_gaps(p, r, every)))
            for name, p, r in (("grad", prog.grad_norms, ref.grad_norms),
                               ("change", prog.change_norms, ref.change_norms))}


def verdict(readings: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """(correct, [{name, value, limit, where}]) in a fixed order."""
    rows = [{"name": k, "value": readings[k][0], "limit": limits[k], "where": readings[k][1]}
            for k in NUMBERS]
    return all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows), rows
