"""The measured window's arithmetic, on the host clock.

A closed loop of one trainer: a step starts when the previous one has
returned, so the step boundaries partition the window.  The rate is every
token of every step completed over the time from the window's start to the
end of its last step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class Window:
    tokens_per_step: int
    bounds: List[float] = field(default_factory=list)     # host seconds: start, end of each step
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    setup_s: float = 0.0

    def seconds(self) -> float:
        return self.bounds[-1] - self.bounds[0]

    def tokens_per_s(self) -> float:
        done = self.attempted - self.failed
        return done * self.tokens_per_step / self.seconds()
