"""Training launcher.

Runs training of a ported architecture, on one GPU or on many, with the
paper's communication phase as a configurable feature:

- ``--comm-mode auto``      gradient averaging by a per-leaf all-reduce
                            (``grad_sync.allreduce_mean_leaves``), the
                            counterpart of XLA's SPMD psum; nothing to
                            average on one rank
- ``--comm-mode explicit``  bucketed hierarchical grad-sync
                            (``repro_torch.parallel.grad_sync``) with
                            optional compression, the paper-faithful
                            Horovod-style communication phase; on one
                            rank it still runs encode -> gather ->
                            dequantize -> fused add

and the paper's *measurement methodology* built in: per-step wall time
(host clock around a step that ends in a device synchronise), median step
time and tokens/s of the whole world printed at the end.

Started by ``torchrun`` (``WORLD_SIZE`` in the environment) it runs one
rank a process over ``torch.distributed``: NCCL on ``--device cuda`` (rank
``r`` on ``cuda:LOCAL_RANK``), gloo on ``--device cpu``.  Parameters are
broadcast from rank 0; each rank trains on its rows of the global batch
when the world size divides it (the JAX train-step spec's
``data_batch_spec``), on all of it otherwise; the loss reported is the
global batch's; only rank 0 prints, and rank 0 writes ``--ckpt-dir``.
Otherwise it runs an in-process world of one rank.

The launcher runs on ``--device cuda`` (the default) and raises when CUDA
is not available; it never carries on on the CPU by itself.  Two flags
exist for short runs and comparisons and are not in the JAX launcher:
``--layers`` cuts the depth, ``--use-pallas never`` takes the plain
versions of every hand-written kernel.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --shape train_4k --batch 1 --steps 5 --comm-mode explicit --compression int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --smoke \
      --steps 20 --comm-mode explicit --compression int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --smoke \
      --steps 3 --comm-mode explicit --compression int8 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \
      -m repro_torch.launch.train --smoke --batch 4 --steps 3 --device cpu \
      --comm-mode explicit --compression int8 --ckpt-dir /tmp/ckpt --ckpt-every 2
"""
from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import save
from repro_torch.configs import CommConfig, INPUT_SHAPES, InputShape, get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, device_put_batch
from repro_torch.models.layers import count_params
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedule import clip_by_global_norm, get_schedule
from repro_torch.parallel.collectives import DistributedWorld, InProcessWorld, World
from repro_torch.parallel.grad_sync import allreduce_mean_leaves, make_plan, sync_grads
from repro_torch.parallel.sharding import batch_shardable, shard_batch
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, value_and_grad


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was asked for but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU on purpose")
    return device


_WORLDS_BUILT = itertools.count()      # process groups this process has made


def build_world(device: torch.device) -> tuple:
    """The counterpart of the JAX launcher's ``build_mesh``: (world, device).

    Under ``torchrun`` (``WORLD_SIZE`` set) this initialises the default
    process group, NCCL for a CUDA device (bound to ``cuda:LOCAL_RANK``
    first) or gloo for the CPU, and returns this rank's
    ``DistributedWorld``; the caller destroys the group.  Otherwise an
    in-process world of one rank."""
    if "WORLD_SIZE" not in os.environ:
        return InProcessWorld(1), device
    import torch.distributed as dist

    # torchrun's store outlives a process group: a second group of this
    # process under the first one's keys would read its stale addresses
    store, rank, size = next(dist.rendezvous("env://"))
    store = dist.PrefixStore(f"repro_torch.world{next(_WORLDS_BUILT)}", store)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=store, rank=rank, world_size=size,
                                device_id=device)
    else:
        dist.init_process_group("gloo", store=store, rank=rank, world_size=size)
    return DistributedWorld(), device


def make_train_step(api, opt, world: World, comm: CommConfig, lr_fn,
                    clip_norm: float = 0.0):
    use_kernels = api.cfg.use_pallas != "never"
    steps = itertools.count()

    def train_step(params, opt_state, batch):
        with trace.span("step", index=next(steps)):
            (loss, metrics), grads = value_and_grad(api.loss_fn, params, batch)
            if comm.mode == "explicit":
                grads = sync_grads(grads, world, comm, use_kernels=use_kernels)
            elif world.size > 1:
                grads = allreduce_mean_leaves(grads, world)
            gnorm = torch.zeros((), device=loss.device)
            if clip_norm > 0:
                with trace.span("step.clip"):
                    grads, gnorm = clip_by_global_norm(grads, clip_norm)
            lr = lr_fn(opt_state.count)
            with trace.span("step.update"):
                new_p, new_o = opt.update(params, opt_state, grads, lr)
        return new_p, new_o, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                              **metrics}
    return train_step


def comm_from_args(args) -> CommConfig:
    """CLI flags -> CommConfig, in one place so the dryrun and the real
    launcher cannot diverge.  ``scheduler``/``sched_chunks`` select the
    comm-schedule IR order ``sync_grads`` issues its collectives in."""
    return CommConfig(mode=args.comm_mode, compression=args.compression,
                      fusion_buffer_mb=args.fusion_mb,
                      hierarchical=not args.flat_allreduce,
                      topk_ratio=args.topk_ratio,
                      scheduler=args.scheduler,
                      sched_chunks=args.sched_chunks)


def config_from_args(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.use_pallas:
        cfg = cfg.replace(use_pallas=args.use_pallas)
    if getattr(args, "remat_policy", ""):
        cfg = cfg.replace(remat_policy=args.remat_policy)
    if cfg.hybrid_block_layers and (cfg.num_layers <= 0
                                    or cfg.num_layers % cfg.hybrid_block_layers):
        # JAX floors num_layers // hybrid_block_layers and drops the rest
        raise ValueError(f"{cfg.name}: --layers must be a positive multiple of "
                         f"{cfg.hybrid_block_layers} (one super-block), got {cfg.num_layers}")
    if cfg.moe is not None and not cfg.hybrid_block_layers and cfg.num_layers <= cfg.moe.first_dense:
        # JAX builds an MoE stack of no layers that its forward never runs
        raise ValueError(f"{cfg.name}: --layers must exceed the {cfg.moe.first_dense} leading "
                         f"dense layer(s) (moe.first_dense), got {cfg.num_layers}")
    return cfg


def dryrun(args) -> dict:
    """Build the comm config, bucket plan, and IR order without training.

    What the runtime *would* execute: CLI flag -> CommConfig ->
    BucketPlan.comm_plan -> bucket order.  The parameter tree is built on
    the ``meta`` device (shapes and dtypes only), so this costs no memory
    even at full width."""
    cfg = config_from_args(args)
    comm = comm_from_args(args)
    api = get_model(cfg)
    params = api.init(None, device="meta")
    plan, _ = make_plan(params, comm.fusion_buffer_mb)
    order = plan.comm_plan(comm).bucket_order()
    print(f"[dryrun] {cfg.name} | comm={comm.mode} "
          f"scheduler={comm.scheduler}/{comm.sched_chunks} | "
          f"{plan.n_buckets} buckets | issue order: {list(order)}")
    return {"arch": cfg.name, "dryrun": True, "comm_mode": comm.mode,
            "scheduler": comm.scheduler, "sched_chunks": comm.sched_chunks,
            "n_buckets": plan.n_buckets, "bucket_order": list(order)}


def run(args, params=None) -> dict:
    """Train ``--steps`` steps; ``params`` (the model's tree on the device)
    replace the random ones drawn from ``--seed``."""
    if args.dryrun:
        return dryrun(args)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    shape = INPUT_SHAPES[args.shape].smoke() if args.smoke else INPUT_SHAPES[args.shape]
    if args.batch or args.seq_len:
        shape = InputShape(shape.name, args.seq_len or shape.seq_len,
                           args.batch or shape.global_batch, shape.kind)
    world, device = build_world(device)
    try:
        return _train(args, cfg, shape, world, device, params)
    finally:
        if isinstance(world, DistributedWorld):
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, cfg, shape: InputShape, world: World, device: torch.device,
           params=None) -> dict:
    log = print if world.rank == 0 else (lambda *a, **k: None)
    comm = comm_from_args(args)
    api = get_model(cfg)
    opt = get_optimizer(args.optimizer)

    if params is None:
        params = api.init(torch.Generator(device=device).manual_seed(args.seed))
    if world.size > 1:
        world.broadcast_(tree_leaves(params))           # equal on every rank, as DDP makes them
    opt_state = opt.init(params)
    n_params = count_params(params)
    sharded = world.size > 1 and batch_shardable(world, shape.global_batch) is not None
    rows = shape.global_batch // world.size if sharded else shape.global_batch
    log(f"[train] {cfg.name} | {n_params/1e6:.1f}M params | {cfg.num_layers} layers | "
        f"device {device} | world {world.size} ({world.backend}), {rows} of "
        f"{shape.global_batch} rows a rank | comm={comm.mode}/{comm.compression}")

    data = SyntheticLM(cfg, shape, seed=args.seed)
    it = Prefetcher(iter(data), depth=2)

    lr_fn = get_schedule(args.schedule, args.lr, args.warmup, args.steps)
    step_fn = make_train_step(api, opt, world, comm, lr_fn, clip_norm=args.clip_norm)
    losses, times = [], []
    t_first = None
    try:
        for step in range(args.steps):
            batch = device_put_batch(shard_batch(next(it), world), device)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if step == 0:
                t_first = dt
            else:
                times.append(dt)
            loss = metrics["loss"]
            if sharded:                                   # the global batch's mean
                loss = world.all_reduce_sum([loss])[0] / world.size
            losses.append(float(loss))
            if step % args.log_every == 0:
                log(f"  step {step:4d} loss {losses[-1]:.4f} "
                    f"({dt*1e3:.0f} ms)")
            if args.ckpt_dir and step and step % args.ckpt_every == 0:
                if world.rank == 0:
                    save(args.ckpt_dir, {"params": params, "opt": opt_state}, step)
                if world.size > 1:
                    world.barrier()
    finally:
        it.close()

    tokens_per_step = shape.global_batch * shape.seq_len
    t_step = float(np.median(times)) if times else float("nan")
    result = {
        "arch": cfg.name, "steps": args.steps,
        "first_loss": losses[0], "last_loss": losses[-1],
        "median_step_s": t_step,
        "compile_s": t_first,      # the first step: kernel build and warm-up
        "tokens_per_s": tokens_per_step / t_step if times else 0.0,
        "loss_decreased": losses[-1] < losses[0],
        "losses": losses, "device": str(device), "num_layers": cfg.num_layers,
        "world": world.size, "backend": world.backend,
    }
    log(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{result['tokens_per_s']:.0f} tok/s "
        f"(median {t_step*1e3:.0f} ms/step)")
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=0,
                    help="sequence length in place of the shape's (0: the shape's)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "constant"])
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--comm-mode", default="auto", choices=["auto", "explicit"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "fp16", "int8", "ternary", "topk"])
    ap.add_argument("--scheduler", default="fifo",
                    choices=["fifo", "priority", "chunked"],
                    help="comm-schedule IR order for explicit grad sync "
                         "(the order the simulator prices)")
    ap.add_argument("--sched-chunks", type=int, default=4,
                    help="chunks per bucket for the pipelined schedulers")
    ap.add_argument("--dryrun", action="store_true",
                    help="build the comm plan and bucket order, skip training")
    ap.add_argument("--fusion-mb", type=float, default=64.0)
    ap.add_argument("--topk-ratio", type=float, default=0.01)
    ap.add_argument("--flat-allreduce", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is none) or cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's; "
                         "jamba-v0.1-52b: a multiple of 8; MoE: more than moe.first_dense)")
    ap.add_argument("--use-pallas", default="", choices=["", "auto", "always", "never"],
                    help="hand-written kernels: auto = on CUDA tensors; never = "
                         "plain versions everywhere (reference runs)")
    ap.add_argument("--remat-policy", default="", choices=["", "full", "dots"],
                    help="recompute in backward: full = each layer whole (the config's "
                         "default); dots = save the products' outputs (the decoders of "
                         "models/transformer.py)")
    return ap


def main(argv=None, params=None):
    return run(build_parser().parse_args(argv), params)


if __name__ == "__main__":
    main()
