"""The reference's compiled dry run, read per device: run as a script, in a
process of its own, because ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to
512 host devices on import (no test process may import it).

  python tests/_torch_reference_dryrun.py '[{"arch": "stablelm-3b", "shape": "train_4k",
      "layers": 2, "remat_policy": "full", "multi_pod": false}, ...]'

For each combination it takes ``repro.launch.dryrun.resolve_cfg``, replaces
``num_layers`` and ``remat_policy``, builds the reference's ``step_spec``
and ``make_step_fn``, jits and compiles the step on
``make_production_mesh`` exactly as ``dryrun_one`` does (which is never
called: it writes under ``artifacts/dryrun/``), and reads the compiled HLO
with ``repro.utils.hlo``'s parser and loop multipliers.  It prints one JSON
list, an entry per combination:

- ``flops``: the ``dot`` FLOPs a device (``hlo.analyze``);
- ``collectives``: ``{axis: {kind: {"elements", "bytes", "dtypes"}}}``, the
  output elements and bytes of every collective a device runs, times its
  loop trips.  ``axis`` is the mesh axis (or the axes, joined by ``+``)
  along which the devices of the op's groups differ: each op's
  ``replica_groups`` (the iota form ``[G,S]<=[dims]T(perm)`` or explicit
  ``{{...}}`` lists; a ``collective-permute``'s ``source_target_pairs``)
  are expanded to device ids and located in the mesh's device array.
"""
from __future__ import annotations

import json
import re
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.launch import dryrun as ref_dryrun  # noqa: E402  (sets XLA_FLAGS first)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import INPUT_SHAPES  # noqa: E402
from repro.launch import specs as specs_lib  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models.registry import get_model  # noqa: E402
from repro.optim.optimizers import get_optimizer  # noqa: E402
from repro.utils import hlo  # noqa: E402

THREADS = 3
_IOTA = re.compile(r"replica_groups=\[([\d,]+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_LISTS = re.compile(r"(?:replica_groups|source_target_pairs)=\{(\{[\d,]*\}(?:,\{[\d,]*\})*)\}")


def groups(rest: str):
    """The device-id groups of one collective's attributes, or None."""
    m = _IOTA.search(rest)
    if m:
        shape = [int(x) for x in m.group(1).split(",")]
        dims = [int(x) for x in m.group(2).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(3):
            ids = ids.transpose([int(x) for x in m.group(3).split(",")])
        return ids.reshape(shape).tolist()
    m = _LISTS.search(rest)
    if m:
        return [[int(x) for x in g.split(",") if x]
                for g in re.findall(r"\{([\d,]*)\}", m.group(1))]
    return None


def axis_of(device_groups, mesh) -> str:
    """The mesh axes along which the devices of any one group differ."""
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    where = {int(i): idx for idx, i in np.ndenumerate(ids)}
    varying = set()
    for g in device_groups:
        coords = [where[d] for d in g]
        varying |= {k for k in range(ids.ndim) if len({c[k] for c in coords}) > 1}
    return "+".join(mesh.axis_names[k] for k in sorted(varying)) or "none"


def analyse(text: str, mesh) -> dict:
    comps = hlo.parse_computations(text)
    mult = hlo._compute_multipliers(comps, hlo._find_entry(text, comps))
    flops = 0.0
    coll = defaultdict(lambda: defaultdict(lambda: {"elements": 0.0, "bytes": 0.0,
                                                    "dtypes": set()}))
    for comp in comps.values():
        m = mult.get(comp.name, 0.0)
        if not m:
            continue
        for op in comp.ops:
            if op.opcode == "dot":
                flops += m * hlo._dot_flops(op, comp)
            kind = re.sub(r"-(start|done)$", "", op.opcode)
            if kind not in hlo.COLLECTIVE_KINDS or op.opcode.endswith("-done"):
                continue
            g = groups(op.rest)
            entry = coll[axis_of(g, mesh) if g else "?"][kind]
            for s in hlo._SHAPE_RE.finditer(op.type_str):
                if s.group(1) in hlo._DTYPE_BYTES:
                    entry["elements"] += m * int(np.prod([int(d) for d in s.group(2).split(",")
                                                          if d] or [1]))
                    entry["dtypes"].add(s.group(1))
            entry["bytes"] += m * hlo._shape_bytes(op.type_str)
    return {"flops": flops,
            "collectives": {a: {k: {**v, "dtypes": sorted(v["dtypes"])} for k, v in kinds.items()}
                            for a, kinds in coll.items()}}


def compiled_step(arch: str, shape: str, layers: int, remat_policy: str, multi_pod: bool):
    cfg, _ = ref_dryrun.resolve_cfg(arch, shape)
    cfg = cfg.replace(num_layers=layers, remat_policy=remat_policy)
    mesh = make_production_mesh(multi_pod=multi_pod)
    api = get_model(cfg)
    opt = get_optimizer("adamw") if INPUT_SHAPES[shape].kind == "train" else None
    spec = specs_lib.step_spec(api, INPUT_SHAPES[shape], mesh, opt)
    fn = specs_lib.make_step_fn(api, spec.kind, opt)
    with mesh:
        jitted = jax.jit(fn, in_shardings=spec.in_shardings, out_shardings=spec.out_shardings,
                         donate_argnums=spec.donate_argnums)
        return jitted.lower(*spec.args).compile().as_text(), mesh


def one(combo: dict) -> dict:
    t0 = time.perf_counter()
    text, mesh = compiled_step(**combo)
    return {**combo, **analyse(text, mesh), "jax": jax.__version__,
            "compile_s": round(time.perf_counter() - t0, 2)}


def main(argv) -> int:
    """Compiles the combinations on ``THREADS`` threads (XLA's compiler
    releases the GIL), the first listed first."""
    with ThreadPoolExecutor(THREADS) as pool:
        out = list(pool.map(one, json.loads(argv[0])))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
