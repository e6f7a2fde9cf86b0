"""Multi-pod dry run: trace every (arch x input-shape x mesh) step on the
production meshes on meta shards, and read what each device would do.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  That one
lowers and compiles each step for 512 host devices; the port runs each
step once in eager mode, on DTensors placed by ``launch/specs.py`` over a
fake process group of 256 or 512 ranks (``main`` opens it in this process:
``launch/mesh.open_fake_world``), each rank's shard a ``meta`` tensor:
nothing is allocated and no collective moves a byte.  (Not
``FakeTensorMode``: DTensor computes the offsets of a strided shard, which
a reshape of two sharded dims makes, with tensor operations, and under a
fake mode those come back as fake tensors that ``tolist()`` cannot read.
Meta shards carry the same shapes and dtypes with no mode active.)  ``utils/step_analysis.analyze`` records per
device FLOPs, bytes, collective bytes and counts by kind and mesh axis,
and the peak of the bytes the step made; the argument and output sizes
come from the local shards.  Those are the inputs to
``benchmarks/torch_roofline.py``.

Meta tensors are not CUDA tensors, so the step runs the plain PyTorch
versions of the kernels (``use_pallas="never"``): the dry run reads the eager
port's traffic, op by op, not the fused kernels' and not XLA's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--production]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.archs import ALL_ARCHS, FULL_ATTENTION, LONG_SKIP
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh, mesh_num_devices, open_fake_world
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.utils.step_analysis import analyze, local_bytes
from repro_torch.utils.tree import tree_leaves

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"


def resolve_cfg(arch: str, shape_name: str, production: bool = False):
    """Apply the long-context variant policy and, when ``production``, the
    §Perf-validated optimization flags."""
    cfg = get_config(arch)
    note = ""
    if production:
        from repro_torch.configs.base import production_overrides
        kw = production_overrides(cfg)
        cfg = cfg.replace(**kw)
        note = "production flags: " + ",".join(sorted(kw))
    if shape_name == "long_500k":
        if arch in LONG_SKIP:
            return None, "skip: enc-dec full attention, 448-token decoder by design"
        if arch in FULL_ATTENTION:
            cfg = cfg.replace(sliding_window=4096)
            note = (note + "; " if note else "") + \
                "swa-4096 variant (sub-quadratic requirement)"
    return cfg, note


def mesh_name(mesh) -> str:
    return "x".join(map(str, tuple(mesh.shape)))


def meta_args(spec: specs_lib.StepSpec, mesh) -> tuple:
    """The spec's meta trees as DTensors placed by its specs, each rank's
    shard a meta tensor."""
    return tuple(arg if sh is None else specs_lib.distribute(arg, sh, mesh)  # None: decode's index
                 for arg, sh in zip(spec.args, spec.in_shardings))


def dryrun_cfg(cfg: ModelConfig, shape: InputShape, mesh, opt_name: str = "adamw") -> dict:
    """Trace one step of ``cfg`` x ``shape`` on ``mesh``; the record's
    measurements (no names)."""
    cfg = cfg.replace(use_pallas="never")
    api = get_model(cfg)
    opt = get_optimizer(opt_name) if shape.kind == "train" else None
    t0 = time.perf_counter()
    spec = specs_lib.step_spec(api, shape, mesh, opt)
    fn = specs_lib.make_step_fn(api, spec.kind, opt)
    args = meta_args(spec, mesh)
    arg_bytes = local_bytes(args)
    held = {id(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)}
    result, ana = analyze(fn, *args, mesh=mesh)
    outs = [t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]
    out_bytes = local_bytes(outs)
    alias_bytes = local_bytes([t for t in outs if id(t) in held])
    trace_s = time.perf_counter() - t0
    return {
        "kind": spec.kind, "mesh": mesh_name(mesh), "axes": list(mesh.mesh_dim_names),
        "devices": mesh_num_devices(mesh),
        "trace_s": round(trace_s, 2),
        "flops": ana.flops,
        "bytes_accessed": ana.bytes,
        "collective_bytes": ana.collective_bytes,
        "analyzed": {
            "flops": ana.flops,
            "bytes": ana.bytes,
            "collective_bytes": ana.collective_bytes,
            "collective_counts": ana.collective_counts,
            "collective_bytes_by_axis": ana.collective_bytes_by_axis,
        },
        "memory": {
            "temp_size_in_bytes": ana.peak_bytes,
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias_bytes,
        },
    }


def dryrun_one(arch: str, shape_name: str, mesh, opt_name: str = "adamw",
               verbose: bool = True, production: bool = False) -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg, note = resolve_cfg(arch, shape_name, production=production)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "production": production, "status": "skipped", "note": note}
    rec = dryrun_cfg(cfg, shape, mesh, opt_name)
    result = {"arch": arch, "shape": shape_name, "production": production,
              "status": "ok", "note": note, **rec}
    if verbose:
        ana = result["analyzed"]
        print(f"[dryrun] {arch} x {shape_name} @ {result['mesh']}"
              f"{' (production)' if production else ''}: OK (trace {rec['trace_s']:.1f}s, "
              f"flops={ana['flops']:.3e}, coll={sum(ana['collective_bytes'].values()):.3e}B "
              f"{ana['collective_bytes']}) {note}")
        print(f"         memory: {result['memory']}")
    return result


def _key(r: dict) -> tuple:
    return r["arch"], r["shape"], r.get("mesh"), r.get("production", False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--production", action="store_true",
                    help="apply the §Perf-validated optimization flags")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pods = [False, True] if args.both_meshes else [args.multi_pod]
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]

    open_fake_world()
    results = []
    for multi_pod in pods:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        for arch in archs:
            for shape in shapes:
                try:
                    results.append(dryrun_one(arch, shape, mesh,
                                              production=args.production))
                except Exception as e:  # a failure here is a bug in the system
                    traceback.print_exc()
                    results.append({"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
                                    "production": args.production,
                                    "status": "FAIL", "error": repr(e)})
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(args.out) if args.out else ARTIFACT_DIR / "torch_results.json"
    existing = []
    if out.exists():
        keys = {_key(r) for r in results}
        existing = [r for r in json.loads(out.read_text()) if _key(r) not in keys]
    out.write_text(json.dumps(existing + results, indent=1))
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(results)} combos, {n_fail} failures -> {out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
