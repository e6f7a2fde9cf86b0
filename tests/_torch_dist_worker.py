"""One rank of the multi-process checks of ``tests/test_torch_distributed.py``.

Run by ``python -m torch.distributed.run --standalone --nproc_per_node 4
tests/_torch_dist_worker.py WHAT OUT_DIR`` (gloo, on the CPU).  Each rank
writes what it computed to ``OUT_DIR/rank<r>.pt``; the test compares the
files with the in-process world and the JAX trainer.

- ``collectives``: the three collectives over every axis of a world with
  ``node_size`` 2, ``sync_grads`` in every mode and ``allreduce_mean_leaves``,
  on per-rank inputs made from seeds (``inputs``, shared with the test).
- ``train``: ``launch.train.main`` in several modes, one after the other in
  this process, recording each run's losses, what rank 0 and the others
  printed, the rows each step saw and the final parameters.
"""
import contextlib
import io
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

K, NODE = 4, 2
SYNC_MODES = {"none-flat": dict(compression="none", hierarchical=False),
              "none-hier": dict(compression="none", hierarchical=True),
              "fp16": dict(compression="fp16"), "int8": dict(compression="int8"),
              "ternary": dict(compression="ternary"), "topk": dict(compression="topk")}
TRAIN_RUNS = {
    "auto": ["--batch", "4", "--comm-mode", "auto"],
    "none": ["--batch", "4", "--comm-mode", "explicit", "--compression", "none"],
    "int8": ["--batch", "4", "--comm-mode", "explicit", "--compression", "int8"],
    "int8-b2": ["--comm-mode", "explicit", "--compression", "int8"],    # smoke batch 2 < K
}
TRAIN_COMMON = ["--smoke", "--steps", "3", "--device", "cpu", "--log-every", "1"]


def inputs(rank: int) -> dict:
    """Rank ``rank``'s collective inputs and gradient tree: at
    ``fusion_buffer_mb`` 0.004 two buckets, ``b`` and the bf16 ``e`` (681
    elements: odd, and no multiple of the codecs' 256), then ``w`` (1,200)."""
    rng = np.random.default_rng(1000 + rank)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return {"x": f32(5, 7),
            "rs": {"world": f32(K, 6), "node": f32(NODE, 6), "cross": f32(K // NODE, 6)},
            "grads": {"w": f32(30, 40), "b": f32(121), "e": f32(7, 80).to(torch.bfloat16)}}


def collectives(world) -> dict:
    from repro_torch.configs import CommConfig
    from repro_torch.parallel.grad_sync import allreduce_mean_leaves, sync_grads

    mine = inputs(world.rank)
    out = {}
    for axis in ("world", "node", "cross"):
        out[f"all_gather/{axis}"] = world.all_gather([mine["x"]], axis)[0]
        out[f"all_reduce_sum/{axis}"] = world.all_reduce_sum([mine["x"]], axis)[0]
        out[f"reduce_scatter_sum/{axis}"] = world.reduce_scatter_sum([mine["rs"][axis]], axis)[0]
    for name, kw in SYNC_MODES.items():
        comm = CommConfig(mode="explicit", fusion_buffer_mb=0.004, **kw)
        out[f"sync/{name}"] = sync_grads(mine["grads"], world, comm)
    out["auto"] = allreduce_mean_leaves(mine["grads"], world)
    return out


def train() -> dict:
    from repro_torch.launch import train as ttrain
    from repro_torch.utils.tree import tree_leaves

    seen = {}
    make = ttrain.make_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def wrapped(params, opt_state, batch):
            out = step(params, opt_state, batch)
            seen.setdefault("rows", []).append(int(batch["tokens"].shape[0]))
            seen["params"] = out[0]
            return out
        return wrapped

    ttrain.make_train_step = recording
    runs = {}
    for name, flags in TRAIN_RUNS.items():
        seen.clear()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            result = ttrain.main(TRAIN_COMMON + flags)
        runs[name] = {"result": result, "printed": printed.getvalue(), "rows": seen["rows"],
                      "params": [t.clone() for t in tree_leaves(seen["params"])]}
    return runs


def main(what: str, out_dir: str) -> None:
    import torch.distributed as dist

    if what == "collectives":
        from repro_torch.parallel.collectives import DistributedWorld

        dist.init_process_group("gloo", timeout=timedelta(seconds=60))
        try:
            world = DistributedWorld(node_size=NODE)
            out = collectives(world)
            rank = world.rank
        finally:
            dist.destroy_process_group()
    else:
        rank = int(os.environ["RANK"])
        out = train()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


if __name__ == "__main__":
    main(*sys.argv[1:3])
