"""The window's arithmetic on synthetic step times with a planted stall."""
import statistics

import pytest

from portbench.harness.window import Window


def _window(times, tokens=4096):
    w = Window(tokens_per_step=tokens)
    t = 100.0
    w.bounds.append(t)
    for dt in times:
        t += dt
        w.bounds.append(t)
    w.attempted = len(times)
    return w


def test_the_rate_covers_the_whole_window():
    times = [0.4] * 99 + [4.0]                       # one stall of ten steps
    w = _window(times)
    assert w.seconds() == pytest.approx(43.6)
    assert w.tokens_per_s() == pytest.approx(100 * 4096 / 43.6)
    # a median of steps would not see the stall
    assert 4096 / statistics.median(times) == pytest.approx(10240.0)
    assert w.tokens_per_s() < 0.95 * 10240.0


def test_failed_steps_add_no_tokens():
    w = _window([0.5] * 10)
    w.failed = 2
    assert w.tokens_per_s() == pytest.approx(8 * 4096 / 5.0)

