"""Tree checkpointing without external dependencies, in the JAX package's
on-disk layout, so that a checkpoint either package writes restores into
the other's tree bit for bit.

Layout: a directory ``step_%08d`` per step (written as ``step_%08d.tmp``
and renamed), one ``leaf_%05d.npy`` per leaf in flatten order (bfloat16
stored as its uint16 bits: numpy has no bfloat16), and ``manifest.json``,
``{"step": step, "leaves": {name: {"file", "shape", "dtype"}}}``.  Leaf
names are the reference's: dict keys as they are, NamedTuple fields as
``.field``, sequence indices as numbers, joined by ``/`` (``params/embed/w``,
``opt/.mu/blocks/attn/wk``, ``opt/.count``).  Restore checks shapes against
a template tree and casts to its dtypes, on its devices.  Tensors are moved
to the host to be written; one process writes everything.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten


def leaf_names(node: Any, prefix: Tuple[str, ...] = ()) -> List[str]:
    """The manifest name of every leaf, in flatten order."""
    if isinstance(node, dict):
        items = [(str(k), node[k]) for k in sorted(node)]
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        items = [(f".{f}", v) for f, v in zip(node._fields, node)]
    elif isinstance(node, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(node)]
    else:
        return ["/".join(prefix)]
    return [n for k, v in items for n in leaf_names(v, prefix + (k,))]


def _flatten_with_names(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    return list(zip(leaf_names(tree), tree_leaves(tree)))


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(directory: str | Path, tree: Any, step: int) -> Path:
    d = Path(directory) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest[name] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps({"step": step, "leaves": manifest}))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)
    return d


def latest_step(directory: str | Path) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    # a ``step_*.tmp`` left by an interrupted save is not a step (the
    # reference's ``int()`` raises on it)
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                   if p.is_dir() and p.suffix != ".tmp")
    return steps[-1] if steps else None


def restore(directory: str | Path, template: Any, step: Optional[int] = None) -> Any:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    leaves = []
    for name, tmpl in _flatten_with_names(template):
        ent = manifest[name]
        arr = np.load(d / ent["file"])
        if ent["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if list(t.shape) != list(tmpl.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"template {tuple(tmpl.shape)}")
        leaves.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
    return tree_unflatten(template, leaves)
