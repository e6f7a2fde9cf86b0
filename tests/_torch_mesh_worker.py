"""One rank of ``tests/test_torch_mesh_gloo.py``: a (2, 2) DeviceMesh of
four gloo processes.

Run by ``python -m torch.distributed.run --standalone --nproc_per_node 4
tests/_torch_mesh_worker.py OUT_DIR``.  Every rank builds the same smoke
stablelm parameters and batch from seeds (``inputs``, shared with the
test), places them by the specs' DTensor placements, reads them back with
``full_tensor()``, and takes one ``make_step_fn(api, "train", opt)`` step
on the mesh.  It writes what it saw to ``OUT_DIR/rank<r>.pt``.
"""
import os
import sys
from datetime import timedelta
from pathlib import Path

import torch

ARCH, B, S, SEED = "stablelm-3b", 4, 128, 0       # S: a multiple of 128, the kernel's condition


def inputs():
    """(api, params, batch) of the smoke model, float32, from seeds."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    cfg = get_config(ARCH).smoke()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32)}
    return api, params, batch


DECODE_B, DECODE_W, DECODE_AT = 1, 16, 5


def decode_inputs():
    """(api, params, token, cache) of one decode step of the smoke model:
    a batch of one against a cache of ``DECODE_W`` slots holding random
    keys and values, the new token written at slot ``DECODE_AT``."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.utils.tree import tree_map

    api, params, _ = inputs()
    gen = torch.Generator().manual_seed(SEED + 2)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen, dtype=t.dtype),
                     init_cache(api.cfg, DECODE_B, DECODE_W))
    token = torch.randint(0, api.cfg.vocab_size, (DECODE_B, 1), generator=gen, dtype=torch.int32)
    return api, params, token, cache


def decode_on(mesh) -> dict:
    """One ``make_step_fn(api, "decode")`` step on ``mesh``: batch 1 cannot
    split over `data`, so the cache's slots do (``cache_pspec``), and the new
    token's key and value land on the one rank that holds slot
    ``DECODE_AT`` (``sharding.write_at``)."""
    from repro_torch.launch import specs
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_leaves

    api, params, token, cache = decode_inputs()
    placed = specs.distribute(params, shd.param_specs(params, api.cfg), mesh)
    cspecs = specs.cache_shardings(api.cfg, mesh, DECODE_B, cache)
    dcache = specs.distribute(cache, cspecs, mesh)
    dtoken = specs.distribute({"tokens": token}, {"tokens": (None, None)}, mesh)
    logits, new_cache = specs.make_step_fn(api, "decode")(placed, dtoken, dcache, DECODE_AT)
    return {"logits": logits.full_tensor(), "specs": cspecs,
            "cache": [t.full_tensor() for t in tree_leaves(new_cache)]}


def on_mesh(out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_leaves

    dist.init_process_group("gloo", timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        api, params, batch = inputs()
        opt = get_optimizer("adamw")
        p_specs = shd.param_specs(params, api.cfg)
        placed = specs.distribute(params, p_specs, mesh)
        # copies: a replicated leaf's full tensor may be its local tensor,
        # which the step then updates in place
        back = [t.full_tensor().clone() for t in tree_leaves(placed)]
        placements = [[str(p) for p in t.placements] for t in tree_leaves(placed)]
        local_shapes = [tuple(t.to_local().shape) for t in tree_leaves(placed)]

        state = specs.distribute(opt.init(params), specs.opt_state_specs(params, api.cfg, mesh), mesh)
        _, bspecs = specs.batch_specs(api.cfg, type("S", (), {"global_batch": B, "seq_len": S,
                                                              "kind": "train"})(), mesh)
        dbatch = specs.distribute(batch, bspecs, mesh)
        step = specs.make_step_fn(api, "train", opt)
        new_p, _, metrics = step(placed, state, dbatch)
        out = {"rank": dist.get_rank(), "back": back, "placements": placements,
               "local_shapes": local_shapes, "loss": metrics["loss"].full_tensor(),
               "new_params": [t.full_tensor() for t in tree_leaves(new_p)]}
        # the flash kernel's route (use_pallas "always"; on CPU shards its
        # plain version) through local_map, from fresh parameters, on the
        # (4, 1) mesh of the same ranks: the route under autograd takes a
        # `model` axis of one rank
        mesh = make_mesh((4, 1), ("data", "model"), "cpu")
        kapi = get_model(api.cfg.replace(use_pallas="always"))
        placed = specs.distribute(inputs()[1], p_specs, mesh)
        state = specs.distribute(opt.init(inputs()[1]), specs.opt_state_specs(params, api.cfg, mesh),
                                 mesh)
        dbatch = specs.distribute(batch, bspecs, mesh)
        _, _, kmetrics = specs.make_step_fn(kapi, "train", opt)(placed, state, dbatch)
        out["kernel_route_loss"] = kmetrics["loss"].full_tensor()
        out["decode"] = decode_on(make_mesh((2, 2), ("data", "model"), "cpu"))
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{out['rank']}.pt")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    on_mesh(sys.argv[1])
