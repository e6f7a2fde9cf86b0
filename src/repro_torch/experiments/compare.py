"""Artifact diffing — the regression gate.

``compare(old, new, tolerances)`` walks two artifacts experiment by
experiment and cell by cell: spec hashes must match, every numeric result
field must agree within its tolerance (|a-b| <= atol + rtol*max(|a|,|b|)),
and no paper-claim validation may flip from passing to failing.  CI runs
this between the committed golden artifact and a fresh sweep; any violation
exits non-zero.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.experiments.runner import index_cells

# default: essentially bit-exactness modulo float formatting (1e-9 abs+rel).
# n_buckets is structural and must match exactly.
NUMERIC_FIELDS = ("scaling_factor", "t_sync", "t_overhead", "t_batch",
                  "t_back", "effective_bw", "effective_gbps",
                  "network_utilization", "wire_bytes_per_worker",
                  "codec_compute_s")
DEFAULT_ATOL = 1e-9
DEFAULT_RTOL = 1e-9


@dataclass(frozen=True)
class Violation:
    experiment: str
    kind: str          # spec | cells | field | validation
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.experiment}] {self.kind} {self.where}: {self.detail}"


@dataclass
class CompareReport:
    n_experiments: int = 0
    n_cells: int = 0
    violations: List[Violation] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        head = (f"compared {self.n_experiments} experiment(s), "
                f"{self.n_cells} cell(s): "
                f"{'OK' if self.ok else f'{len(self.violations)} violation(s)'}")
        lines = [head] + [f"  {v}" for v in self.violations]
        lines += [f"  note: {n}" for n in self.notes]
        return "\n".join(lines)


def _tol(tolerances: Optional[Dict[str, float]], fieldname: str) -> float:
    if tolerances and fieldname in tolerances:
        return tolerances[fieldname]
    return DEFAULT_ATOL


def _compare_cells(name: str, old: Sequence[Dict], new: Sequence[Dict],
                   tolerances: Optional[Dict[str, float]],
                   report: CompareReport) -> None:
    old_ix, new_ix = index_cells(old), index_cells(new)
    for key in old_ix.keys() - new_ix.keys():
        report.violations.append(Violation(name, "cells", str(key),
                                           "missing from new artifact"))
    for key in new_ix.keys() - old_ix.keys():
        report.violations.append(Violation(name, "cells", str(key),
                                           "absent from old artifact"))
    for key in sorted(old_ix.keys() & new_ix.keys(), key=str):
        a, b = old_ix[key], new_ix[key]
        report.n_cells += 1
        # hardened sweeps record retry-exhausted cells with failure
        # metadata instead of numerics: a new-side failure where the old
        # artifact has real numbers is a regression; an old-side failure
        # has nothing to diff against, so skip-and-report
        if b.get("failed") and not a.get("failed"):
            report.violations.append(Violation(
                name, "cells", str(key),
                f"cell failed in new artifact: {b.get('error', '?')}"))
            continue
        if a.get("failed"):
            report.notes.append(
                f"[{name}] {key}: old-side cell failed "
                f"({a.get('error', '?')}); numerics skipped")
            continue
        if a.get("n_buckets") != b.get("n_buckets"):
            report.violations.append(Violation(
                name, "field", f"{key}.n_buckets",
                f"{a.get('n_buckets')} != {b.get('n_buckets')}"))
        for f in NUMERIC_FIELDS:
            if f not in a and f not in b:
                continue
            if f not in a or f not in b:
                # a field present on one side only is a schema regression,
                # not a silent skip — drift checking for it would vanish
                report.violations.append(Violation(
                    name, "field", f"{key}.{f}",
                    f"present only in {'old' if f in a else 'new'} artifact"))
                continue
            va, vb = float(a[f]), float(b[f])
            atol = _tol(tolerances, f)
            bound = atol + DEFAULT_RTOL * max(abs(va), abs(vb))
            if abs(va - vb) > bound:
                report.violations.append(Violation(
                    name, "field", f"{key}.{f}",
                    f"old={va!r} new={vb!r} |diff|={abs(va - vb):.3e} "
                    f"> tol={bound:.3e}"))


def compare(old_art: Dict, new_art: Dict,
            tolerances: Optional[Dict[str, float]] = None) -> CompareReport:
    """Diff two artifact dicts (as returned by ``artifacts.read``)."""
    report = CompareReport()
    old_ex = {e["name"]: e for e in old_art.get("experiments", [])}
    new_ex = {e["name"]: e for e in new_art.get("experiments", [])}

    for name in sorted(old_ex.keys() - new_ex.keys()):
        report.violations.append(Violation(name, "cells", "-",
                                           "experiment missing from new"))
    for name in sorted(new_ex.keys() - old_ex.keys()):
        report.notes.append(f"experiment {name!r} only in new artifact")

    for name in sorted(old_ex.keys() & new_ex.keys()):
        a, b = old_ex[name], new_ex[name]
        report.n_experiments += 1
        if a.get("spec_hash") != b.get("spec_hash"):
            report.violations.append(Violation(
                name, "spec", "spec_hash",
                f"{a.get('spec_hash')} != {b.get('spec_hash')} "
                f"(grids differ; refresh the golden artifact deliberately)"))
            continue
        _compare_cells(name, a.get("cells", []), b.get("cells", []),
                       tolerances, report)
        old_val = a.get("validations", {})
        new_val = b.get("validations", {})
        for check, passed in sorted(old_val.items()):
            if passed and not new_val.get(check, False):
                report.violations.append(Violation(
                    name, "validation", check,
                    "paper claim passed in old artifact, fails in new"))
    return report
