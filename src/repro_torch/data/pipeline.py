"""Synthetic data pipeline.

Deterministic on (seed, step) so every data-parallel worker can generate
its own shard without coordination.  Batches are generated with numpy, by
the same recipe as the JAX package's pipeline, so both frameworks see
identical tokens; ``device_put_batch`` moves them to the device through
pinned host memory.
"""
from __future__ import annotations

import queue as queue_lib
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig


class SyntheticLM:
    """Zipf-distributed token stream (vocab ranks follow a power law, like
    natural text) with next-token labels."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, seed: int = 0,
                 zipf_a: float = 1.2):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.probs = p / p.sum()

    def batch(self, step: int, batch_size: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        B = batch_size or self.shape.global_batch
        S = self.shape.seq_len
        rng = np.random.default_rng((self.seed, step))
        stream = rng.choice(self.cfg.vocab_size, size=(B, S + 1), p=self.probs)
        return {"tokens": stream[:, :-1].astype(np.int32),
                "labels": stream[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Host-side prefetch: overlaps next-batch generation with the step."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue_lib.Queue = queue_lib.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                # a bounded put that gives up once close() was called, so
                # the thread never blocks forever on a full queue
                while not self._stop.is_set():
                    try:
                        self.q.put(item, timeout=0.1)
                        break
                    except queue_lib.Full:
                        continue
                if self._stop.is_set():
                    return

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue_lib.Empty:
            pass
        self.t.join(timeout=5.0)


def device_put_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Place a host batch on ``device``; on CUDA through pinned memory with
    a non-blocking copy."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out
