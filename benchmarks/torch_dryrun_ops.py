"""Per-op matmul FLOPs of one dry-run step (``repro_torch.launch.dryrun``):
which products a device runs, at which local shapes, and how many FLOPs
each contributes.  Run it under two torch releases and diff the lists to
find the ops whose placement DTensor chooses differently.

  PYTHONPATH=src python benchmarks/torch_dryrun_ops.py --arch jamba-v0.1-52b \
      --layers 8 --multi-pod [--top 40]

Prints the step's per-device FLOPs and collective bytes by mesh axis, then
one line per (op, local operand shapes): FLOPs a device, summed over the
step.  ``--out PATH`` also writes both lists as JSON, with one entry per
(collective kind, mesh axis, local output shape, dtype): its count and
bytes, so that two releases' runs can be diffed.  Counts only, from meta
shards: no time.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, open_fake_world  # noqa: E402
from repro_torch.utils import step_analysis  # noqa: E402


def flops_by_op(arch: str, shape: str, layers: int, multi_pod: bool,
                collectives: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    """(the dry run's record, {(op, local shapes): FLOPs}) of ``arch`` at
    ``layers`` (0: its depth) on a production mesh; ``collectives``, when
    given, is filled with {(kind, axis, local shape, dtype): [count,
    bytes]}."""
    open_fake_world()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cfg, _ = dryrun.resolve_cfg(arch, shape)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    return ops_of(cfg, INPUT_SHAPES[shape], mesh, collectives)


def ops_of(cfg, shape, mesh, collectives: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    """``flops_by_op`` of one config and input shape on a mesh."""
    acc: Dict[Tuple[str, tuple], float] = collections.Counter()
    record = step_analysis._Recorder.__torch_dispatch__
    collective = step_analysis._Recorder._collective

    def listing(self, name, args, out):
        before = {a: dict(k) for a, k in self._by_axis.items()}
        collective(self, name, args, out)
        if collectives is None:
            return
        for axis, kinds in self._by_axis.items():
            for kind, nbytes in kinds.items():
                grown = nbytes - before.get(axis, {}).get(kind, 0.0)
                if grown:
                    t = step_analysis._tensors(out)[0]
                    entry = collectives.setdefault(
                        (kind, axis, tuple(t.shape), str(t.dtype)), [0, 0.0])
                    entry[0] += 1
                    entry[1] += grown

    def counting(self, func, types, args=(), kwargs=None):
        before = self.out.flops
        out = record(self, func, types, args, kwargs)
        if self.out.flops != before:
            shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            acc[(str(func), shapes)] += self.out.flops - before
        return out

    step_analysis._Recorder.__torch_dispatch__ = counting
    step_analysis._Recorder._collective = listing
    try:
        rec = dryrun.dryrun_cfg(cfg, shape, mesh)
    finally:
        step_analysis._Recorder.__torch_dispatch__ = record
        step_analysis._Recorder._collective = collective
    return rec, dict(acc)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python benchmarks/torch_dryrun_ops.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=0, help="depth (0: the config's)")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=None, help="write the op and collective lists as JSON")
    args = ap.parse_args(argv)
    colls: Dict = {}
    rec, ops = flops_by_op(args.arch, args.shape, args.layers, args.multi_pod, colls)
    if args.out:
        Path(args.out).write_text(json.dumps({
            "torch": torch.__version__, "record": rec,
            "ops": sorted([op, [list(s) for s in shapes], f] for (op, shapes), f in ops.items()),
            "collectives": sorted([k, a, list(s), d, n, b]
                                  for (k, a, s, d), (n, b) in colls.items())}, indent=1))
    print(f"{args.arch} {args.shape} @ {rec['mesh']} (torch {torch.__version__}): "
          f"{rec['flops']:.4e} FLOPs a device; collective bytes by axis "
          f"{rec['analyzed']['collective_bytes_by_axis']}")
    for (op, shapes), flops in sorted(ops.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"{flops:.4e} {op} {shapes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
