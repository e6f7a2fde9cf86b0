"""The training traffic: Zipf-distributed tokens, deterministic on
(seed, step), frozen here from the program's ``data.pipeline.SyntheticLM``.

Vocabulary ranks follow a power law of exponent ``zipf_a`` (1.2, as
natural text roughly does); each step draws ``batch`` rows of ``seq + 1``
tokens, the inputs and their next-token labels.  Every step's rows differ;
the same seed gives the same batches, whatever the machine.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class ZipfBatches:
    def __init__(self, vocab: int, seq: int, batch: int, seed: int, zipf_a: float = 1.2):
        self.seq, self.batch, self.seed, self.vocab = seq, batch, int(seed), vocab
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.probs = p / p.sum()

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        stream = rng.choice(self.vocab, size=(self.batch, self.seq + 1), p=self.probs)
        return {"tokens": stream[:, :-1].astype(np.int32),
                "labels": stream[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self(step)
            step += 1


def for_cell(vocab: int, traffic: dict, seed: int) -> ZipfBatches:
    return ZipfBatches(vocab, traffic["seq_len"], traffic["batch"], seed, traffic["zipf_a"])
