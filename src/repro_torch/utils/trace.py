"""The program's one tracer: spans and counters, on the profiler's clock.

``span(name, **attrs)`` marks a stretch of the program.  While nothing
records it returns one shared null context (a flag read).  While
recording it keeps a ``Record`` in memory: the name, an id, the id of the
span it opened inside, the id of its ``step`` span, ``attrs``, and host
start and end from ``time.time_ns()``, the clock of ``torch.profiler``'s
events, so a span can be laid over a profile.  It also opens a
``torch.profiler.record_function`` range of its name, and where CUDA is
initialised records a pair of timing events on the current stream; they
are resolved to device ms, with one synchronise, when ``records()`` is
read.

Recording is on while a ``torch.profiler`` profile runs (the profiler sets
``torch.autograd.profiler._is_profiler_enabled`` on start) and inside
``recording()``; nothing else switches it.

A span's parent is the innermost span open on its own thread or, on a
thread with none open, the innermost open on any: autograd runs a CUDA
backward on a thread of its own, and the spans opened there
(``layer.recompute``, ``attn.backward``) belong under ``step.backward``.

The spans of the training step: ``step`` (``launch/train.make_train_step``,
the whole step; ``attrs["counts"]`` holds every counter's change over it);
``step.forward``, ``step.backward`` (``utils/tree.value_and_grad``);
``layer.recompute`` (``models/transformer``: a checkpointed layer run again
by backward); ``attn.backward`` (``models/attention._FlashKernelFn``);
``step.sync`` and, a bucket each, ``sync.pack``, ``sync.encode``,
``sync.gather``, ``sync.decode``, ``sync.add``, ``sync.unpack``
(``parallel/grad_sync``); ``step.clip``, ``step.update``.

``count(name, n)`` always counts, into one cumulative registry:
``launch.<kernel>`` (a hand-written kernel launched), ``route.<route>``
(a launch on a kernel's second route, counted under ``launch.`` as well),
``sync.bytes_packed`` (float32 bytes packed into buckets),
``sync.bytes_gathered`` (bytes handed to ``all_gather``) and
``stack.unbound`` (a stacked layer leaf cut once by ``torch.unbind`` in
``models/transformer.forward``; DTensor leaves are sliced and not counted).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

STEP = "step"
NULL = contextlib.nullcontext()

_lock = threading.Lock()
_local = threading.local()
_open: List["_Span"] = []           # every open span, in the order opened
_records: List["Record"] = []       # closed spans, in the order closed
_ids = itertools.count()
_explicit = 0                       # open ``recording()`` contexts
_counts: Counter = Counter()


@dataclass
class Record:
    name: str
    id: int
    parent: Optional[int]
    step: Optional[int]
    attrs: dict
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def ms(self) -> float:
        """Device ms; host ms where the span recorded no device events."""
        return self.host_ms if self.device_ms is None else self.device_ms


def is_recording() -> bool:
    return _explicit > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside, with no profiler running."""
    global _explicit
    with _lock:
        _explicit += 1
    try:
        yield
    finally:
        with _lock:
            _explicit -= 1


def span(name: str, **attrs):
    if not (_explicit or _profiler._is_profiler_enabled):
        return NULL
    return _Span(name, attrs)


class _Span:
    __slots__ = ("record", "_range", "_counts0")

    def __init__(self, name: str, attrs: dict):
        self.record = Record(name, -1, None, None, attrs, 0)

    def __enter__(self) -> Record:
        rec = self.record
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            rec.id = next(_ids)
            outer = stack[-1] if stack else (_open[-1] if _open else None)
            if outer is not None:
                rec.parent, rec.step = outer.record.id, outer.record.step
            if rec.name == STEP:
                rec.step = rec.id
                self._counts0 = Counter(_counts)
            _open.append(self)
        stack.append(self)
        rec.start_ns = time.time_ns()
        self._range = torch.profiler.record_function(rec.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start, start)
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        try:
            if rec.events is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec.events = (rec.events[0], end)
            self._range.__exit__(*exc)
        finally:
            rec.end_ns = time.time_ns()
            _local.stack.remove(self)
            with _lock:
                _open.remove(self)
                if rec.name == STEP:
                    rec.attrs["counts"] = {k: v - self._counts0[k] for k, v in _counts.items()
                                           if v != self._counts0[k]}
                _records.append(rec)
        return False


def records() -> List[Record]:
    """The closed spans, in the order they closed, their device ms resolved."""
    with _lock:
        out = list(_records)
    pending = [r for r in out if r.events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return out


def clear() -> None:
    """Drop the records kept so far."""
    with _lock:
        _records.clear()


def self_ms(recs: List[Record]) -> List[Tuple[Record, float]]:
    """Each record with its self time: its ms less its children's."""
    inner = Counter()
    for r in recs:
        if r.parent is not None:
            inner[r.parent] += r.ms
    return [(r, r.ms - inner[r.id]) for r in recs]


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] += n


def counts(prefix: str = "") -> Counter:
    """A copy of the counters (a name never counted reads 0); with
    ``prefix``, those named ``<prefix>.<x>``, under ``x``."""
    with _lock:
        if not prefix:
            return Counter(_counts)
        cut = len(prefix) + 1
        return Counter({k[cut:]: v for k, v in _counts.items() if k.startswith(prefix + ".")})


def reset_counts(prefix: str = "") -> None:
    """Zero the counters, or those named ``<prefix>.<x>``."""
    with _lock:
        for k in [k for k in _counts if not prefix or k.startswith(prefix + ".")]:
            del _counts[k]
