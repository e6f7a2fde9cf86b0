"""§Perf hillclimb driver for the port: trace one (arch x shape) on the
single-pod mesh with config-knob overrides and print the three roofline
terms, priced on the H100.

The port's counterpart of ``benchmarks/perf_lab.py``: the step runs through
``repro_torch.launch.dryrun.dryrun_cfg`` (DTensors of meta shards over a
fake process group of 256 ranks, opened in this process) instead of an XLA
compile, and the terms use ``benchmarks/torch_roofline.py``'s pricing
(per-axis links).

  PYTHONPATH=src python benchmarks/torch_perf_lab.py --arch jamba-v0.1-52b \\
      --shape train_4k --set mamba_fused_y=True --tag fused_y

Results are appended to ``artifacts/perf/torch_<arch>_<shape>.json`` so
iterations accumulate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))
sys.path.insert(0, str(REPO_ROOT))

from benchmarks.torch_roofline import collective_seconds  # noqa: E402
from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.launch.dryrun import dryrun_cfg, resolve_cfg  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, make_production_mesh,  # noqa: E402
                                     open_fake_world)

ARTIFACTS = REPO_ROOT / "artifacts" / "perf"


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def run_variant(arch: str, shape_name: str, overrides: dict, tag: str,
                verbose: bool = True, mesh=None) -> dict:
    cfg, note = resolve_cfg(arch, shape_name)
    if cfg is None:
        raise ValueError(f"{arch} x {shape_name} skipped by design: {note}")
    if overrides:
        cfg = cfg.replace(**overrides)
    if mesh is None:
        open_fake_world()
        mesh = make_production_mesh(device_type="cpu")
    rec = dryrun_cfg(cfg, INPUT_SHAPES[shape_name], mesh)
    ana = rec["analyzed"]
    result = {
        "tag": tag, "arch": arch, "shape": shape_name,
        "overrides": overrides, "note": note, "mesh": rec["mesh"],
        "trace_s": rec["trace_s"],
        "compute_s": ana["flops"] / PEAK_FLOPS_BF16,
        "memory_s": ana["bytes"] / HBM_BW,
        "collective_s": collective_seconds(rec),
        "flops": ana["flops"], "bytes": ana["bytes"],
        "collective_bytes": ana["collective_bytes"],
        "collective_bytes_by_axis": ana["collective_bytes_by_axis"],
        "temp_gib": rec["memory"]["temp_size_in_bytes"] / 2**30,
    }
    if verbose:
        print(f"[perf] {arch} x {shape_name} [{tag}] "
              f"compute={result['compute_s']*1e3:.1f}ms "
              f"memory={result['memory_s']*1e3:.1f}ms "
              f"collective={result['collective_s']*1e3:.1f}ms "
              f"temp={result['temp_gib']:.1f}GiB")
        print(f"       collectives: "
              f"{ {k: f'{v/1e9:.1f}GB' for k, v in ana['collective_bytes'].items()} }")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override, e.g. mamba_fused_y=True")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    result = run_variant(args.arch, args.shape, parse_overrides(args.set), args.tag)
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    out = ARTIFACTS / f"torch_{args.arch}_{args.shape}.json"
    hist = json.loads(out.read_text()) if out.exists() else []
    hist = [h for h in hist if h["tag"] != args.tag] + [result]
    out.write_text(json.dumps(hist, indent=1))
    print(f"-> {out}")
    return result


if __name__ == "__main__":
    main()
