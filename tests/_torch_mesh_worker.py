"""One rank of ``tests/test_torch_mesh_gloo.py``: a (2, 2) DeviceMesh of
four gloo processes.

Run by ``python -m torch.distributed.run --standalone --nproc_per_node 4
tests/_torch_mesh_worker.py OUT_DIR``.  Every rank builds the same smoke
stablelm parameters and batch from seeds (``inputs``, shared with the
test), places them by the specs' DTensor placements, reads them back with
``full_tensor()``, and takes one ``make_step_fn(api, "train", opt)`` step
on the mesh, and the same step of one smoke model of each other family
(``FAMILY_ARCHS``) on the (2, 2) mesh, and the gradients of a dense and an
MoE decoder under ``seq_parallel="data"`` (``grads_on``), one decode step
of the dense and the MLA decoder (``decode_on``) and of each of
``DECODE_CASES`` (``decode_case_on``), and the gradients of the
attention on a (1, 4) mesh whose `model` axis the kv heads do not divide
(``HEAD_SPLITS``).  It writes what it
saw to
``OUT_DIR/rank<r>.pt``.
"""
import os
import sys
from datetime import timedelta
from pathlib import Path

import torch

ARCH, B, S, SEED = "stablelm-3b", 4, 128, 0       # S: a multiple of 128, the kernel's condition


# one smoke model of each family the dry run's fixed lowering touches beyond
# the dense decoder: MoE experts on shards, MLA, the WKV recurrence, the
# Mamba scan with MoE, and Whisper's encoder and cross-attention
FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-236b", "rwkv6-1.6b", "jamba-v0.1-52b",
                "whisper-base")
FAMILY_S = 64


def inputs(arch: str = ARCH, seq: int = S, **overrides):
    """(api, params, batch) of the smoke model (``cfg.replace(**overrides)``),
    float32, from seeds; the other families take a sequence of
    ``FAMILY_S``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.registry import get_model

    cfg = get_config(arch).smoke().replace(**overrides)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, seq), generator=gen, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (B, seq), generator=gen, dtype=torch.int32)}
    if cfg.family == "encdec":
        frames = SyntheticLM(cfg, type("S", (), {"global_batch": B, "seq_len": seq,
                                                 "kind": "train"})(), seed=SEED).batch(0)["frames"]
        batch["frames"] = torch.from_numpy(frames)
    return api, params, batch


# sequence parallelism over `model` (cfg.seq_parallel = "data"): one dense
# and one MoE decoder, their loss and gradients on the (2, 2) mesh
SEQ_PARALLEL_ARCHS = ("stablelm-3b", "moonshot-v1-16b-a3b")


# the attention on a `model` axis of 4 that its 2 kv heads do not divide
# (``attention._on_shards``): the (row, kv head) pairs split over it, with
# the smoke's 2 query heads a kv head, or one
HEAD_SPLITS = {"two-query-heads-a-kv-head": ("stablelm-3b", {}),
               "one-query-head-a-kv-head": ("stablelm-3b", {"num_heads": 2, "num_kv_heads": 2}),
               "encoder-decoder": ("whisper-base", {"num_heads": 2, "num_kv_heads": 2})}


def grads_on(mesh, arch: str, shape: dict = None, **overrides) -> dict:
    """The loss and every gradient leaf, whole, of ``arch`` (``FAMILY_S``
    tokens, ``cfg.replace(**overrides)``) on ``mesh``, from the seeds'
    parameters placed by the specs; ``shape``: ``cfg.replace(**shape)``
    before the parameters are made."""
    from repro_torch.launch import specs
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_leaves, value_and_grad

    api, params, batch = inputs(arch, FAMILY_S, **(shape or {}))
    api = get_model(api.cfg.replace(**overrides))
    placed = specs.distribute(params, shd.param_specs(params, api.cfg), mesh)
    shape = type("S", (), {"global_batch": B, "seq_len": FAMILY_S, "kind": "train"})()
    _, bspecs = specs.batch_specs(api.cfg, shape, mesh)
    specs._register_dtensor_rules()
    with specs._constants_replicated(placed, specs.distribute(batch, bspecs, mesh)):
        (loss, _), grads = value_and_grad(api.loss_fn, placed,
                                          specs.distribute(batch, bspecs, mesh))
    return {"loss": loss.full_tensor(), "grads": [g.full_tensor() for g in tree_leaves(grads)]}


def train_on(mesh, arch: str = ARCH, use_pallas: str = "") -> dict:
    """One ``make_step_fn(api, "train", opt)`` step of ``arch`` on ``mesh``,
    from the seeds' parameters: the loss and the new parameters, whole."""
    from repro_torch.launch import specs
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_leaves

    seq = S if arch == ARCH else FAMILY_S
    api, params, batch = inputs(arch, seq)
    if use_pallas:
        api = get_model(api.cfg.replace(use_pallas=use_pallas))
    opt = get_optimizer("adamw")
    placed = specs.distribute(params, shd.param_specs(params, api.cfg), mesh)
    state = specs.distribute(opt.init(params), specs.opt_state_specs(params, api.cfg, mesh), mesh)
    shape = type("S", (), {"global_batch": B, "seq_len": seq, "kind": "train"})()
    _, bspecs = specs.batch_specs(api.cfg, shape, mesh)
    new_p, _, metrics = specs.make_step_fn(api, "train", opt)(
        placed, state, specs.distribute(batch, bspecs, mesh))
    return {"loss": metrics["loss"].full_tensor(),
            "new_params": [t.full_tensor() for t in tree_leaves(new_p)]}


DECODE_B, DECODE_W, DECODE_AT = 1, 16, 5


# the MLA decoder's decode step: its latent cache's slots split over both
# axes (no kv heads to split over `model`)
MLA_ARCH = "deepseek-v2-236b"


def decode_inputs(arch: str = ARCH):
    """(api, params, token, cache) of one decode step of the smoke model:
    a batch of one against a cache of ``DECODE_W`` slots holding random
    keys and values, the new token written at slot ``DECODE_AT``."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.utils.tree import tree_map

    api, params, _ = inputs(arch)
    gen = torch.Generator().manual_seed(SEED + 2)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen, dtype=t.dtype),
                     init_cache(api.cfg, DECODE_B, DECODE_W))
    token = torch.randint(0, api.cfg.vocab_size, (DECODE_B, 1), generator=gen, dtype=torch.int32)
    return api, params, token, cache


# decode steps of every lowering a decode takes on a mesh: (arch, batch).
# A batch of one is whole over `data`: the residual stream splits on d_model
# over it and every product splits over `data` (``layers.project``), fsdp
# weights on their own shards; a batch of two gives each `data` rank one
# row, one token, fewer than the `model` ranks: RWKV's channel mix and decay
# LoRA split their columns (``sharding.linear``), the fsdp decoders gather
# the rows for their output-split weights (``sharding.rows_gathered``) and
# look their tokens up in the table's own rows; Whisper's cross-attention
# splits its (row, head) pairs
DECODE_CASES = {"fsdp-decoder-batch-1": ("command-r-35b", 1),
                "dp-decoder-batch-1": ("stablelm-3b", 1),
                "rwkv-fewer-tokens-than-model-ranks": ("rwkv6-1.6b", 2),
                "rwkv-batch-1": ("rwkv6-1.6b", 1),
                "moe-batch-1": ("moonshot-v1-16b-a3b", 1),
                "mla-moe-batch-1": ("deepseek-v2-236b", 1),
                "hybrid-batch-1": ("jamba-v0.1-52b", 1),
                "fsdp-decoder-a-row-a-rank": ("command-r-35b", 2),
                "mla-moe-a-row-a-rank": ("deepseek-v2-236b", 2),
                "whisper-a-row-a-rank": ("whisper-base", 2)}


def decode_case_inputs(arch: str, batch: int):
    """(api, params, token, cache) of one decode step of the smoke model:
    ``batch`` rows against a cache (``api.cache_spec``, ``DECODE_W``
    slots) of random values, the new token at index ``DECODE_AT``."""
    from repro_torch.launch import specs
    from repro_torch.utils.tree import tree_map

    api, params, _ = inputs(arch)
    gen = torch.Generator().manual_seed(SEED + 3)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen, dtype=t.dtype),
                           specs.cache_structs(api, batch, DECODE_W))
    token = torch.randint(0, api.cfg.vocab_size, (batch, 1), generator=gen, dtype=torch.int32)
    return api, params, token, cache


def decode_case_on(mesh, arch: str, batch: int) -> dict:
    """One ``make_step_fn(api, "decode")`` step of ``decode_case_inputs``
    on ``mesh``, placed by the specs: its logits and returned cache, whole."""
    from repro_torch.launch import specs
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_leaves

    api, params, token, cache = decode_case_inputs(arch, batch)
    placed = specs.distribute(params, shd.param_specs(params, api.cfg), mesh)
    dcache = specs.distribute(cache, specs.cache_shardings(api.cfg, mesh, batch, cache), mesh)
    _, bspecs = specs.decode_batch_specs(api.cfg, type("S", (), {"global_batch": batch})(), mesh)
    dtoken = specs.distribute({"tokens": token}, bspecs, mesh)
    logits, new_cache = specs.make_step_fn(api, "decode")(placed, dtoken, dcache, DECODE_AT)
    return {"logits": logits.full_tensor(),
            "cache": [t.full_tensor() for t in tree_leaves(new_cache)]}


def decode_on(mesh, arch: str = ARCH) -> dict:
    """One ``make_step_fn(api, "decode")`` step on ``mesh``: batch 1 cannot
    split over `data`, so the cache's slots do (``cache_pspec``), and the new
    token's key and value land on the one rank that holds slot
    ``DECODE_AT`` (``sharding.write_at``)."""
    from repro_torch.launch import specs
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_leaves

    api, params, token, cache = decode_inputs(arch)
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
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        out["decode"] = decode_on(mesh)
        out["decode_mla"] = decode_on(mesh, MLA_ARCH)
        out["decode_cases"] = {name: decode_case_on(mesh, *case)
                               for name, case in DECODE_CASES.items()}
        # the kernel's route with the heads split over `model` too
        out["kernel_route_2x2"] = train_on(mesh, use_pallas="always")["loss"]
        out["families"] = {arch: train_on(mesh, arch) for arch in FAMILY_ARCHS}
        out["seq_parallel"] = {arch: grads_on(mesh, arch, seq_parallel="data")
                               for arch in SEQ_PARALLEL_ARCHS}
        mesh = make_mesh((1, 4), ("data", "model"), "cpu")
        out["head_splits"] = {name: grads_on(mesh, arch, shape)
                              for name, (arch, shape) in HEAD_SPLITS.items()}
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{out['rank']}.pt")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    on_mesh(sys.argv[1])
