"""Gradient-ready timelines, the white-box timing input to the simulator.

Counterpart of ``repro/core/timeline.py``.  The paper instruments training
scripts with per-parameter hooks to log *gradient-computation-done* times.
Ported here:

- ``from_layer_profile``: spread a known batch time over the layers;
- ``from_cnn``: the paper's three workloads, from their analytic profiles
  (``core.cnn_profiles``) and a batch time, the V100's by default or one
  measured on this card;
- ``from_transformer``: any ported architecture x input shape, from the
  per-layer parameter/FLOP model in ``core.flops`` at an assumed MFU of the
  H100's dense bf16 rate (the reference assumes a TPU's);
- ``measure``: time fwd+bwd on the params' device and spread the backward
  over the top-level parameter groups by FLOP share, as the reference does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cnn_profiles import CNNProfile, get_profile

# fraction of compute time spent in backward (2x fwd FLOPs for matmul nets)
BWD_FRACTION = 2.0 / 3.0


@dataclass(frozen=True)
class GradTimeline:
    """Backward-pass gradient availability schedule.

    ``ready_times[i]`` (seconds from backward start, ascending) is when
    gradient chunk i (``sizes[i]`` bytes) becomes available; ``t_back`` is
    backward completion, ``t_batch`` the full fwd+bwd iteration time.
    """

    name: str
    ready_times: Tuple[float, ...]
    sizes: Tuple[float, ...]
    t_back: float
    t_batch: float

    @property
    def total_bytes(self) -> float:
        return float(sum(self.sizes))


def from_layer_profile(name: str, layer_bytes: Sequence[float],
                       layer_bwd_times: Sequence[float],
                       t_batch: float) -> GradTimeline:
    """layer_bytes / layer_bwd_times in *forward* order."""
    assert len(layer_bytes) == len(layer_bwd_times)
    n = len(layer_bytes)
    # backward visits layers last -> first
    ready, sizes = [], []
    t = 0.0
    for i in reversed(range(n)):
        t += layer_bwd_times[i]
        ready.append(t)
        sizes.append(float(layer_bytes[i]))
    return GradTimeline(name, tuple(ready), tuple(sizes), t_back=t,
                        t_batch=float(t_batch))


def from_cnn(name: str, t_batch: Optional[float] = None,
             grad_dtype_bytes: int = 4) -> GradTimeline:
    """Timeline for resnet50 / resnet101 / vgg16: the V100's batch time of
    the paper's setup by default, or ``t_batch`` (seconds)."""
    prof: CNNProfile = get_profile(name)
    tb = t_batch if t_batch is not None else prof.t_batch_v100
    flops = np.array([l.flops for l in prof.layers], dtype=np.float64)
    total = flops.sum()
    # layers with zero conv FLOPs (bn) get a tiny epsilon share
    share = (flops + 1e-9 * total) / (flops + 1e-9 * total).sum()
    bwd_times = share * (tb * BWD_FRACTION)
    layer_bytes = [l.params * grad_dtype_bytes for l in prof.layers]
    return from_layer_profile(prof.name, layer_bytes, bwd_times, tb)


# NVIDIA H100 SXM data sheet: 989 TFLOP/s of dense bf16 on the tensor cores
# (1,979 with 2:4 sparsity), the peak every operations bound in PERF.md uses.
H100_BF16_FLOPS = 989e12


def from_transformer(cfg, shape, *, mfu: float = 0.4,
                     chip_flops: float = H100_BF16_FLOPS,
                     n_chips_compute: int = 1,
                     grad_dtype_bytes: int = 2) -> GradTimeline:
    """Timeline for a ported architecture on an H100 at ``mfu`` of its dense
    bf16 rate.

    ``n_chips_compute`` divides the per-layer compute time (model-parallel
    group size); gradient sizes are the *per-replica* gradient bytes.
    """
    from repro_torch.core.flops import layer_breakdown

    layers = layer_breakdown(cfg, shape)     # [(name, params, fwd_flops)]
    eff = mfu * chip_flops * n_chips_compute
    fwd_times = np.array([l[2] for l in layers], dtype=np.float64) / eff
    t_fwd = fwd_times.sum()
    bwd_times = 2.0 * fwd_times
    t_batch = float(t_fwd + bwd_times.sum())
    layer_bytes = [l[1] * grad_dtype_bytes for l in layers]
    return from_layer_profile(f"{cfg.name}:{shape.name}", layer_bytes,
                              bwd_times, t_batch)


def measure(api, cfg, batch, repeats: int = 3, *, params=None,
            device="cuda") -> GradTimeline:
    """Measured timeline: the mean time of ``repeats`` fwd+bwd passes of
    ``api.loss_fn`` (after one warm-up), backward spread over the top-level
    parameter groups by FLOP share.

    ``params`` default to ``api.init`` with seed 0 on ``device``; the
    timing runs on the params' device (host clock around work that ends in
    a synchronize on CUDA).  Like the reference, this times the whole pass
    and spreads it; per-parameter gradient hooks would log real ready times
    and are beyond the reference."""
    import torch

    from repro_torch.core.flops import layer_breakdown_from_params
    from repro_torch.utils.tree import tree_leaves, value_and_grad

    if params is None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("timeline.measure: no CUDA device (pass device='cpu')")
        params = api.init(torch.Generator(device=device).manual_seed(0))
    dev = tree_leaves(params)[0].device
    batch = {k: v.to(dev) for k, v in batch.items()}

    def step():
        _, grads = value_and_grad(api.loss_fn, params, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return grads

    step()                                             # warm-up
    t0 = time.perf_counter()
    for _ in range(repeats):
        step()
    t_batch = (time.perf_counter() - t0) / repeats
    layers = layer_breakdown_from_params(params, cfg)
    fl = np.array([l[2] for l in layers], dtype=np.float64)
    share = (fl + 1e-9 * fl.sum()) / (fl + 1e-9 * fl.sum()).sum()
    bwd = share * t_batch * BWD_FRACTION
    layer_bytes = [l[1] * 4 for l in layers]
    return from_layer_profile(f"{cfg.name}-measured", layer_bytes, bwd, t_batch)
