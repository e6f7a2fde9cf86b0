"""``benchmarks/torch_roofline.py``: the H100 roofline over the port's
dry-run records.  A hand-built record is priced by the formula with
``launch/mesh.py``'s H100 constants (each mesh axis at its link), and with
v5e's constants and one link for all collective bytes the row is the
reference ``benchmarks/roofline.py``'s (that module imports
``repro.launch.mesh``, which sets no ``XLA_FLAGS``)."""
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))                                   # benchmarks/

from benchmarks import roofline as jroof  # noqa: E402
from benchmarks import torch_roofline as troof  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.core.flops import model_flops  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402


def record(mesh_name="16x16", axes=("data", "model")):
    by_axis = {"data": {"all-reduce": 3.0e9, "all-gather": 1.0e9},
               "model": {"all-reduce": 2.0e9, "reduce-scatter": 0.5e9}}
    if "pod" in axes:
        by_axis["pod"] = {"all-reduce": 0.25e9}
    total = {}
    for coll in by_axis.values():
        for k, v in coll.items():
            total[k] = total.get(k, 0.0) + v
    return {"arch": "stablelm-3b", "shape": "train_4k", "kind": "train", "mesh": mesh_name,
            "axes": list(axes), "devices": 256 if mesh_name == "16x16" else 512,
            "status": "ok", "note": "", "production": False,
            "flops": 4.0e14, "bytes_accessed": 2.0e12, "collective_bytes": total,
            "analyzed": {"flops": 4.0e14, "bytes": 2.0e12, "collective_bytes": total,
                         "collective_counts": {}, "collective_bytes_by_axis": by_axis},
            "memory": {"temp_size_in_bytes": 3 * 2 ** 30}}


def test_the_h100_constants():
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.HBM_BW == 3.35e12
    assert mesh.NVLINK_BW == 450e9 and mesh.IB_BW == 50e9
    assert mesh.HBM_BYTES == 80 * 2 ** 30 and mesh.GPUS_PER_NODE == 8


def test_every_production_axis_crosses_nodes_and_small_axes_do_not():
    for shape, axes in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        for axis in axes:
            assert mesh.axis_link(shape, axes, axis) == ("ib", mesh.IB_BW)
    assert mesh.axis_link((32, 8), ("data", "model"), "model") == ("nvlink", mesh.NVLINK_BW)
    assert mesh.axis_link((32, 8), ("data", "model"), "data") == ("ib", mesh.IB_BW)
    assert mesh.axis_link((2, 4), ("data", "model"), "data") == ("nvlink", mesh.NVLINK_BW)


@pytest.mark.parametrize("mesh_name,axes", [("16x16", ("data", "model")),
                                            ("2x16x16", ("pod", "data", "model"))])
def test_the_row_is_the_formula_with_the_h100_constants(mesh_name, axes):
    rec = record(mesh_name, axes)
    row = troof.roofline_row(rec)
    assert row["compute_s"] == pytest.approx(4.0e14 / 989e12, rel=1e-12)
    assert row["memory_s"] == pytest.approx(2.0e12 / 3.35e12, rel=1e-12)
    wire = 2 * 3.0e9 + 1.0e9 + 2 * 2.0e9 + 0.5e9 + (2 * 0.25e9 if "pod" in axes else 0.0)
    assert row["collective_s"] == pytest.approx(wire / 50e9, rel=1e-12)     # every axis on IB
    terms = {k: row[k + "_s"] for k in ("compute", "memory", "collective")}
    assert row["dominant"] == max(terms, key=terms.get) == "memory"
    cfg, shape = get_config("stablelm-3b"), INPUT_SHAPES["train_4k"]
    assert row["model_flops_ratio"] == pytest.approx(
        model_flops(cfg, shape) / rec["devices"] / 4.0e14, rel=1e-12)
    assert row["temp_hbm_gib"] == 3.0


def test_with_v5e_constants_the_row_is_the_reference_row():
    rec = record()
    want = jroof.roofline_row(rec)
    got = troof.roofline_row(rec, peak_flops=jmesh.PEAK_FLOPS_BF16, hbm_bw=jmesh.HBM_BW,
                             link_bw=jmesh.ICI_BW)
    for key in ("compute_s", "memory_s", "collective_s", "model_flops_ratio", "temp_hbm_gib"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    for key in ("arch", "shape", "mesh", "kind", "dominant", "note"):
        assert got[key] == want[key], key


def test_load_table_and_markdown(tmp_path, capsys):
    recs = [record(), {"arch": "whisper-base", "shape": "long_500k", "mesh": "16x16",
                       "status": "skipped", "note": "skip: by design"},
            {"arch": "stablelm-3b", "shape": "prefill_32k", "mesh": "16x16", "status": "FAIL"}]
    path = tmp_path / "torch_results.json"
    path.write_text(json.dumps(recs))
    rows = troof.load_table(path)
    assert [r.get("kind") for r in rows] == ["train", "skipped"]
    md = troof.to_markdown(rows)
    assert md.count("\n") == 4 and "| whisper-base | long_500k | 16x16 | — |" in md
    assert "**memory**" in md
    troof.main(str(path))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch,shape,mesh,production") and len(out) == 3
