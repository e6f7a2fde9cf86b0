"""The reference's training steps: the same weights and batches as the
program's first steps, followed in float32 (TF32 off).

A step is the loss and its gradient (the ``loss`` of the configuration's
reference, ``port.reference``: ``reference/model.py`` by default), the
gradient sync of one rank a batch shard (each rank's gradient through the codec, then their
mean), clipping by the global norm, and AdamW with bias correction and
decoupled weight decay on leaves of two dims or more.  The weights are held
between steps in the configuration's dtype, as the configuration states the
model (bfloat16): each update is computed in float32 and rounded to it.  The codec is the
frozen bucket plan (``counts.buckets``) and the int8 round trip: a scale of
max|x| / 127 a block of 256, codes rounded half to even and clipped to
+-127.  What it reads: each step's loss, each leaf's first gradient as
AdamW gets it, each leaf's change over the steps.

State that changes by a rule and not by the gradient (DeepSeek-V3's
router correction bias, b_i += gamma * sign(mean load - load_i),
arXiv:2412.19437 §2.1.2) is the reference's: its ``loss`` returns
``(loss, extra)`` in place of the loss, and its ``after_update(params,
extras, arch)`` is called after AdamW each step with ``{path: float32
weight}`` and every rank's ``extra``, to change the weights in place;
they are then rounded to the stored dtype again.  The leaves that its
``ruled_leaves(arch)`` names are moved by that rule alone: no gradient is
taken of them (they travel in the sync as zeros, in their place in the
bucket plan), and they get no AdamW moment, update or weight decay.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.counts import arch as arch_lib, buckets
from portbench.counts.arch import Arch
from portbench.harness.weights import sort_key
from portbench.reference.precision import PRODUCTS

BLOCK = 256


@dataclass
class Readings:
    paths: List[str]
    losses: List[float]
    grad_norms: List[float]        # each leaf's first gradient, as AdamW gets it
    change_norms: List[float]      # each leaf's change over the steps followed
    ruled: Tuple[str, ...] = ()    # leaves moved by the reference's rule, not by AdamW


def int8_round_trip(flat: torch.Tensor) -> torch.Tensor:
    n = flat.numel()
    rows = torch.nn.functional.pad(flat, (0, (-n) % buckets.PAD_UNIT)).reshape(-1, BLOCK)
    amax = rows.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(rows / scale), -127, 127)
    return (q * scale).reshape(-1)[:n]


def sync(per_rank: Sequence[Sequence[torch.Tensor]], compression: str, itemsize: int,
         fusion_mb: float) -> List[torch.Tensor]:
    """The mean over ranks of each leaf, every rank's buckets through the codec."""
    if compression not in ("int8", "none"):
        raise ValueError(f"the reference has no codec {compression!r}")
    first = per_rank[0]
    sizes = [g.numel() for g in first]
    out: List[torch.Tensor] = [None] * len(first)  # type: ignore[list-item]
    for leaves in buckets.plan(sizes, itemsize, fusion_mb):
        total = None
        for grads in per_rank:
            flat = torch.cat([grads[i].reshape(-1) for i in leaves])
            if compression == "int8":
                flat = int8_round_trip(flat)
            total = flat if total is None else total + flat
        total = total / len(per_rank)
        off = 0
        for i in leaves:
            out[i] = total[off:off + sizes[i]].reshape(first[i].shape)
            off += sizes[i]
    return out


def follow(a: Arch, weights: Dict[str, torch.Tensor], batches: Sequence[Dict[str, np.ndarray]],
           traffic: dict, world: int = 1, precision: str = "float32",
           half: bool = False) -> Readings:
    """Follow ``len(batches)`` steps from ``weights`` (any dtype; held in
    float32 here).  ``precision="fp8"`` is the control; ``half`` plants the
    half-batch fault."""
    ref = arch_lib.module(a, "reference")
    after_update = getattr(ref, "after_update", None)
    ruled = ruled_leaves(a)
    mm = PRODUCTS[precision]
    opt, comm = traffic["optimizer"], traffic["comm"]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    lr, clip = traffic["lr"], traffic["clip_norm"]
    stored = getattr(torch, a.dtype)
    itemsize = torch.empty((), dtype=stored).element_size()
    paths = sorted(weights, key=sort_key)
    if not set(ruled) <= set(paths):
        raise ValueError(f"{a.name}: ruled_leaves names {sorted(set(ruled) - set(paths))}, "
                         f"which are not leaves")
    graded = [i for i, k in enumerate(paths) if k not in ruled]
    device = weights[paths[0]].device
    p = [weights[k].to(torch.float32, copy=True).requires_grad_(k not in ruled) for k in paths]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    losses: List[float] = []
    grad_norms: List[float] = []
    for step, batch in enumerate(batches):
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        # a world that divides the batch splits its rows, else every rank
        # trains on all of them and their identical gradients average to one
        shards = world if tokens.shape[0] % world == 0 else 1
        rows = tokens.shape[0] // shards
        per_rank, extras, loss_sum = [], [], 0.0
        for r in range(shards):
            sl = slice(r * rows, (r + 1) * rows)
            value = ref.loss(dict(zip(paths, p)), tokens[sl], labels[sl], a, mm, half)
            if isinstance(value, tuple):
                value, extra = value
                extras.append(extra)
            per_rank.append(_grads(value, p, [k in ruled for k in paths]))
            loss_sum += float(value.detach())
        losses.append(loss_sum / len(per_rank))
        with torch.no_grad():
            g = sync(per_rank, comm["compression"], itemsize, comm["fusion_buffer_mb"])
            del per_rank
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g))
            scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
            g = [t * scale for t in g]
            if step == 0:
                grad_norms = [float(torch.linalg.vector_norm(t)) for t in g]
            c = torch.tensor(float(step + 1))
            bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
            for i in graded:
                w, gi, m, v = p[i], g[i], mu[i], nu[i]
                m.mul_(b1).add_(gi, alpha=1 - b1)
                v.mul_(b2).add_(gi * gi, alpha=1 - b2)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if w.dim() >= 2:
                    upd.add_(w, alpha=wd)
                w.copy_((w - lr * upd).to(stored))
            del g
            if after_update is not None:
                after_update(dict(zip(paths, p)), extras, a)
                for w in p:
                    w.copy_(w.to(stored))
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm(w - weights[k].float())) for k, w in zip(paths, p)]
    return Readings(paths, losses, grad_norms, change, ruled)


def _grads(value: torch.Tensor, p: Sequence[torch.Tensor],
           ruled: Sequence[bool]) -> List[torch.Tensor]:
    """The gradient of ``value`` for every leaf, zeros for a ruled one.  A
    function of its own, so that nothing but the list it returns holds the
    gradients once the sync has taken them."""
    got = iter(torch.autograd.grad(value, [w for w, r in zip(p, ruled) if not r]))
    return [torch.zeros_like(w) if r else next(got) for w, r in zip(p, ruled)]


def ruled_leaves(a: Arch) -> Tuple[str, ...]:
    """The leaves the configuration's reference moves by its rule alone
    (its ``ruled_leaves(arch)``; none where it defines none)."""
    rule = getattr(arch_lib.module(a, "reference"), "ruled_leaves", None)
    return tuple(rule(a)) if rule is not None else ()
