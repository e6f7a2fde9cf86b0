"""Roofline analysis of the port's dry-run records, priced on the H100.

The port's counterpart of ``benchmarks/roofline.py``.  Reads
``artifacts/dryrun/torch_results.json`` (written by ``python -m
repro_torch.launch.dryrun``) and derives, per (arch x shape x mesh):

    compute term    = FLOPs_per_device / PEAK_FLOPS_BF16              [s]
    memory term     = bytes_per_device / HBM_BW                       [s]
    collective term = sum over mesh axes of
                      wire_bytes(axis) / the bandwidth of its link     [s]

with ``launch/mesh.py``'s H100 constants.  The dry run's counts are per
device already (it reads the ops on one rank's shards), so nothing is
divided by the device count.  Wire bytes per device come from the summed
*output* bytes of the collectives: an all-reduce moves ~2x its output over
a ring, everything else ~1x.

The H100 has no ICI: a collective runs over NVLink (450 GB/s a GPU) when its
group lies inside one 8-GPU node and over InfiniBand (50 GB/s a GPU) when
it crosses nodes (``launch/mesh.axis_link``).  With ranks laid out
row-major, on the 16x16 mesh `model` is 16 consecutive ranks, two nodes, so
it takes InfiniBand, and so does `data` (a stride of 16 ranks); on the
2x16x16 mesh `pod`, `data` and `model` all cross nodes too.  Every axis of
both production meshes is priced at InfiniBand; a mesh whose axis fits a
node (``model`` of 8 or less) would get NVLink for it.

The dry run's bytes are the eager port's traffic, one kernel an op, not
XLA's fusion boundaries: the memory term is not comparable with a TPU
figure.  MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference)
against the traced FLOPs gives the useful-compute ratio.

  PYTHONPATH=src python benchmarks/torch_roofline.py [torch_results.json]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.core.flops import model_flops  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, axis_link  # noqa: E402

ARTIFACTS = REPO_ROOT / "artifacts" / "dryrun"

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}



def wire_bytes(coll: Dict[str, float]) -> float:
    return sum(_WIRE_FACTOR.get(k, 1.0) * v for k, v in coll.items())


def collective_seconds(rec: Dict, link_bw: Optional[float] = None) -> float:
    """Each axis's wire bytes over its link, summed; with ``link_bw`` all
    collective bytes over that one bandwidth (the reference's pricing)."""
    ana = rec.get("analyzed") or {}
    if link_bw is not None:
        return wire_bytes(ana.get("collective_bytes", rec.get("collective_bytes", {}))) / link_bw
    shape = tuple(int(s) for s in rec["mesh"].split("x"))
    return sum(wire_bytes(coll) / axis_link(shape, rec["axes"], axis)[1]
               for axis, coll in ana.get("collective_bytes_by_axis", {}).items())


def roofline_row(rec: Dict, *, peak_flops: float = PEAK_FLOPS_BF16, hbm_bw: float = HBM_BW,
                 link_bw: Optional[float] = None) -> Optional[Dict]:
    """One row; ``peak_flops``, ``hbm_bw`` and ``link_bw`` default to the
    H100 (per-axis links); pass another chip's to price it there."""
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    shape = INPUT_SHAPES[rec["shape"]]
    n_dev = rec["devices"]
    ana = rec.get("analyzed")
    flops, nbytes = (ana["flops"], ana["bytes"]) if ana else (rec["flops"], rec["bytes_accessed"])
    t_compute = flops / peak_flops
    t_memory = nbytes / hbm_bw
    t_coll = collective_seconds(rec, link_bw)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape) / n_dev          # useful FLOPs per device
    ratio = mf / flops if flops else 0.0
    hbm_gib = rec["memory"].get("temp_size_in_bytes", 0) / 2**30
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec.get("kind", ""), "production": rec.get("production", False),
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant,
        "model_flops_ratio": ratio,
        "temp_hbm_gib": hbm_gib,
        "note": rec.get("note", ""),
    }


def load_table(path: Optional[Path] = None) -> List[Dict]:
    path = path or (ARTIFACTS / "torch_results.json")
    recs = json.loads(Path(path).read_text())
    rows = []
    for rec in recs:
        row = roofline_row(rec)
        if row:
            rows.append(row)
        elif rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh", ""), "kind": "skipped",
                         "production": rec.get("production", False),
                         "note": rec.get("note", "")})
    return rows


def _mesh_label(r: Dict) -> str:
    return r["mesh"] + (" prod" if r.get("production") else "")


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute ms | memory ms | collective ms "
           "| dominant | useful-FLOP ratio | temp GiB |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r.get("kind") == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {_mesh_label(r)} | — | — "
                       f"| — | skipped | — | — |\n")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_mesh_label(r)} "
            f"| {r['compute_s']*1e3:.2f} | {r['memory_s']*1e3:.2f} "
            f"| {r['collective_s']*1e3:.2f} | **{r['dominant']}** "
            f"| {r['model_flops_ratio']:.2f} | {r['temp_hbm_gib']:.1f} |\n")
    return "".join(out)


def main(path: Optional[str] = None):
    rows = load_table(Path(path) if path else None)
    print("arch,shape,mesh,production,compute_ms,memory_ms,collective_ms,dominant,"
          "useful_flop_ratio,temp_hbm_gib")
    for r in rows:
        prod = int(bool(r.get("production")))
        if r.get("kind") == "skipped":
            print(f"{r['arch']},{r['shape']},{r['mesh']},{prod},,,,skipped,,")
            continue
        print(f"{r['arch']},{r['shape']},{r['mesh']},{prod},"
              f"{r['compute_s']*1e3:.3f},{r['memory_s']*1e3:.3f},"
              f"{r['collective_s']*1e3:.3f},{r['dominant']},"
              f"{r['model_flops_ratio']:.3f},{r['temp_hbm_gib']:.2f}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
