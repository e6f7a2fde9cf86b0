"""One run of a training cell: the program's step built as its launcher
builds it, its first steps checked, the window measured, the reference
followed.

The step is ``repro_torch.launch.train.make_train_step`` over the
program's model, AdamW, the world of ``launch.train.build_world`` (one
rank in process, or one rank a process when the launcher set
``WORLD_SIZE``) and the mix's ``CommConfig``; weights from
``weights.make``; batches from the frozen Zipf generator through the
program's ``Prefetcher`` and ``device_put_batch``.  Each step ends as the
launcher's does: a device synchronise, then the loss read on the host.

Set-up runs the cell's checked steps through that same step and feed,
reading the program's losses, its first gradients (from AdamW's first
moment) and its weights' change, then the window runs for ``seconds``.
After it the program's state is freed and the reference follows the same
steps from the same seed (rank 0 only).  The reference, its layout and its
rule for its own leaves' values are those of the configuration's
``port.reference`` (``counts/arch.module``).
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Optional

import torch

from portbench.counts import arch as arch_lib
from portbench.harness import check, spec, traffic as traffic_lib, weights
from portbench.harness.tracing import STEP, Spans, name_gaps, reduce_profile
from portbench.harness.window import Window
from portbench.reference.train import Readings, follow, ruled_leaves


TRACE_FROM = 1          # the window's first step, untraced, then the cell's traced steps


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def _no_moment(path: str, ruled) -> float:
    if path not in ruled:
        raise KeyError(f"the optimizer's state holds no moment of {path}, which AdamW moves")
    return 0.0


def program_leaves(cell: spec.Cell):
    """The program's model api, its meta tree, and [(path, shape)]; the
    reference's layout must be the same."""
    from repro_torch.models.registry import get_model
    from repro_torch.utils.tree import tree_leaves, tree_paths

    api = get_model(spec.model_config(cell))
    meta = api.init(None, device="meta")
    leaves = [(p, tuple(t.shape)) for p, t in zip(tree_paths(meta), tree_leaves(meta))]
    ref = arch_lib.module(cell.arch, "reference")
    expected = sorted(ref.leaves(cell.arch), key=lambda ps: weights.sort_key(ps[0]))
    if leaves != expected:
        raise RuntimeError(f"{cell.config}: the program's parameter tree is not the reference's "
                           f"layout:\n  program   {leaves}\n  reference {expected}")
    return api, meta, leaves


class Program:
    """The training step and its state, built once and handed from set-up
    to the window."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device, spans: Optional[Spans]):
        from repro_torch.configs import CommConfig
        from repro_torch.data.pipeline import Prefetcher, device_put_batch
        from repro_torch.launch import train as train_mod
        from repro_torch.optim.optimizers import get_optimizer
        from repro_torch.optim.schedule import get_schedule
        from repro_torch.parallel.sharding import batch_shardable, shard_batch
        from repro_torch.utils.tree import tree_unflatten

        t = cell.traffic
        self.api, meta, self.leaves = program_leaves(cell)
        self.ruled = ruled_leaves(cell.arch)
        self.world, self.device = train_mod.build_world(device)
        w = weights.make(self.leaves, seed, self.device, getattr(torch, cell.arch.dtype),
                         getattr(arch_lib.module(cell.arch, "reference"), "init", None))
        self.params = tree_unflatten(meta, [w.pop(p) for p, _ in self.leaves])
        o = t["optimizer"]
        opt = get_optimizer(o["name"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                            weight_decay=o["weight_decay"])
        if spans is not None:
            opt = spans.install(train_mod, opt)
        self.opt_state = opt.init(self.params)
        lr_fn = get_schedule(t["schedule"], t["lr"], 0, 0)
        self.step_fn = train_mod.make_train_step(self.api, opt, self.world, CommConfig(**t["comm"]),
                                                 lr_fn, clip_norm=t["clip_norm"])
        self.sharded = (self.world.size > 1
                        and batch_shardable(self.world, t["batch"]) is not None)
        self.feed = Prefetcher(iter(traffic_lib.for_cell(cell.arch.vocab, t, seed)), depth=2)
        self._put = lambda batch: device_put_batch(shard_batch(batch, self.world), self.device)

    def step(self) -> float:
        batch = self._put(next(self.feed))
        self.params, self.opt_state, metrics = self.step_fn(self.params, self.opt_state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        loss = metrics["loss"]
        if self.sharded:                                  # the global batch's mean
            loss = self.world.all_reduce_sum([loss])[0] / self.world.size
        return float(loss)

    def checked_steps(self, n: int, b1: float) -> Readings:
        """The first ``n`` steps, with the program's readings.  A leaf that
        the reference moves by a rule may have no moment in the optimizer's
        state; its first gradient then reads 0 (``check.gaps`` reads none
        of a ruled leaf's)."""
        from repro_torch.utils.tree import tree_leaves, tree_paths

        paths = [p for p, _ in self.leaves]
        start = [p.clone() for p in tree_leaves(self.params)]
        losses, grads = [], []
        for i in range(n):
            losses.append(self.step())
            if i == 0:
                mu = self.opt_state.mu
                moments = {k: m for k, m in zip(tree_paths(mu), tree_leaves(mu)) if m is not None}
                grads = [_norm(moments[k]) / (1.0 - b1) if k in moments
                         else _no_moment(k, self.ruled) for k in paths]
        change = [_norm(p.float() - s.float()) for p, s in zip(tree_leaves(self.params), start)]
        return Readings(paths, losses, grads, change, self.ruled)

    def close(self):
        """Stop the feed, free the state, and leave the process group."""
        self.feed.close()
        del self.params, self.opt_state, self.step_fn
        if self.world.size > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def _profiler(with_host: bool):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA]
                   + ([ProfilerActivity.CPU] if with_host else []))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float) -> dict:
    """One run; returns {"window", "trace", "world", "rank"} and, on rank
    0, "correct" and "checks"."""
    cuda = device.type == "cuda"
    spans = Spans() if trace else None
    prog = Program(cell, seed, device, spans)
    b1 = cell.traffic["optimizer"]["b1"]
    checked = prog.checked_steps(int(cell.cell["checked_steps"]), b1)

    win = Window(tokens_per_step=cell.tokens_per_step)
    first, n_traced = TRACE_FROM, int(cell.cell["trace_steps"])
    gap_step = first + n_traced                       # profiled with the host's operations
    if cuda:
        torch.cuda.reset_peak_memory_stats(prog.device)
    t0 = time.perf_counter()
    win.setup_s = time.time() - t_process
    win.bounds.append(t0)
    while True:
        i = win.attempted
        if trace and i == first:
            prof = _profiler(with_host=False)
            prof.start()
            spans.active = True
            t_traced = time.perf_counter()
        if trace and i == gap_step:
            gap_prof = _profiler(with_host=True)
            gap_prof.start()
        ranged = torch.profiler.record_function(STEP) if trace and i == gap_step else contextlib.nullcontext()
        with ranged:
            loss = prog.step()
        now = time.perf_counter()
        win.attempted += 1
        win.failed += not math.isfinite(loss)
        win.bounds.append(now)
        if trace and i == gap_step - 1:
            window_s = now - t_traced
            spans.active = False
            prof.stop()
        if trace and i == gap_step:
            gap_prof.stop()
        if now - t0 >= seconds and (not trace or i >= gap_step):
            break
    if cuda:
        peak = torch.tensor(torch.cuda.max_memory_allocated(prog.device), device=prog.device)
        if prog.world.size > 1:
            import torch.distributed as dist
            dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        win.peak_bytes = int(peak)
    tr = None
    if trace:
        tr = reduce_profile(prof, spans.ms(), n_traced, window_s)
        tr.idle_gaps = name_gaps(gap_prof)
        spans.uninstall()
        del prof, gap_prof
    world, rank, device, leaves = prog.world.size, prog.world.rank, prog.device, prog.leaves
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    out = {"window": win, "trace": tr, "world": world, "rank": rank, "device": device,
           "leaf_sizes": [math.prod(shape) for _, shape in leaves],
           "itemsize": torch.empty((), dtype=getattr(torch, cell.arch.dtype)).element_size()}
    if rank == 0:
        ref = reference_readings(cell, seed, device, world)
        readings = check.gaps(checked, ref)
        out["correct"], out["checks"] = check.verdict(readings, spec.limits(cell))
    return out


def reference_readings(cell: spec.Cell, seed: int, device: torch.device, world: int,
                       precision: str = "float32", half: bool = False) -> Readings:
    """The reference's readings of the cell's checked steps, from the seed,
    in float32 with TF32 off (the flags are put back after)."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        n = int(cell.cell["checked_steps"])
        gen = traffic_lib.for_cell(cell.arch.vocab, cell.traffic, seed)
        ref = arch_lib.module(cell.arch, "reference")
        w = weights.make(ref.leaves(cell.arch), seed, device, getattr(torch, cell.arch.dtype),
                         getattr(ref, "init", None))
        return follow(cell.arch, w, [gen(i) for i in range(n)], cell.traffic, world, precision,
                      half)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

