"""What the traced run (``--trace 1``) records, from the benchmark's side.

Spans: CUDA events recorded around the calls that the program's training
step makes by name (``value_and_grad``, ``sync_grads`` and
``clip_by_global_norm`` of ``repro_torch.launch.train``, and the
optimizer's ``update``), by wrapping them for the traced run only; nothing
in the program is edited.  A name the program no longer has is left
unwrapped, and the metrics that read it find nothing.

Profile: ``torch.profiler`` of the device alone (CUPTI's kernel records,
no host operations, which would slow the host) over a stretch of whole
steps; the traced window is that stretch on the host clock (each step ends
by reading its loss, so its kernels have run) and busy time is the union
of the device's intervals in it.  One more step is then profiled with the
host's operations, inside a ``portbench.step`` range, only to name the
device's idle gaps by what the host was doing.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

STEP = "portbench.step"
WRAPPED = ("value_and_grad", "sync_grads", "clip_by_global_norm")


class Spans:
    """CUDA events around wrapped calls, while ``active``."""

    def __init__(self):
        self.active = False
        self.events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, fn, name: str):
        def wrapped(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out
        return wrapped

    def install(self, train_module, opt):
        """Wrap the step's calls; returns the optimizer to build the step with."""
        for name in WRAPPED:
            if hasattr(train_module, name):
                fn = getattr(train_module, name)
                self._undo.append((train_module, name, fn))
                setattr(train_module, name, self.wrap(fn, name))
        return dataclasses.replace(opt, update=self.wrap(opt.update, "update"))

    def uninstall(self):
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)
        self._undo.clear()

    def ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in self.events.items()}


@dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    launches: List[Tuple[str, float]]             # (kernel name, device seconds), in order
    spans: Dict[str, List[float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernels_named(self, prefix: str) -> List[float]:
        """Device seconds of each launch whose name has a word starting
        with ``prefix`` (``quantize_int8`` is not found in ``dequantize_int8``)."""
        word = re.compile(r"\b" + re.escape(prefix))
        return [s for name, s in self.launches if word.search(name)]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device(prof) -> List[Tuple[float, float, str]]:
    """(start s, end s, name) of every device operation in the profile; a
    host range's shadow on the device is not one."""
    from torch.autograd import DeviceType

    return [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != STEP
            and not getattr(e, "is_user_annotation", False)]


def reduce_profile(prof, spans: Dict[str, List[float]], steps: int, window_s: float,
                   top: int = 10) -> Trace:
    """The traced steps' busy time (the union of the device's intervals),
    launches and top device operations, from a profile of the device alone
    that covers those steps and nothing else."""
    device = sorted(_device(prof))
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, n in device:
        by_op[n[:160]] += b - a
    return Trace(steps=steps, window_s=window_s,
                 busy_s=sum(b - a for a, b in _union([(a, b) for a, b, _ in device])),
                 launches=[(n, b - a) for a, b, n in device], spans=spans,
                 device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:top])


def name_gaps(prof, top: int = 10) -> List[Tuple[str, float]]:
    """The device's idle gaps inside the profile's ``portbench.step``
    ranges, summed by the innermost host operation that was running at each
    gap's middle, longest first.  The profile records host operations, which
    slows the host: its gaps are longer than an untraced step's."""
    from torch.autograd import DeviceType

    steps, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            continue
        (steps if e.name == STEP else host).append(
            (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name))
    gaps: Dict[str, float] = defaultdict(float)
    host.sort()
    for w0, w1, _ in steps:
        inside = [(max(a, w0), min(b, w1)) for a, b, _ in _device(prof) if b > w0 and a < w1]
        edges = [w0] + [t for iv in _union(inside) for t in iv] + [w1]
        active: List[Tuple[float, float, str]] = []
        nxt = 0
        for a, b in zip(edges[0::2], edges[1::2]):      # in time order: a sweep over the host ops
            if b <= a:
                continue
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt][0] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] >= mid]
            name = min(active, key=lambda h: h[1] - h[0])[2][:160] if active else "(no host operation)"
            gaps[name] += b - a
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
