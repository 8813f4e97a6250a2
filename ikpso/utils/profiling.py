"""Tracing / profiling: timers and jax.profiler hooks.

The reference's only instrumentation is printf of per-run error and
frames-to-converge (reference Main.cpp:195,201; SURVEY.md §5). Here:
wall-clock timers that block on device completion and a jax.profiler
trace context for device timelines (counted ops: ``utils.flops``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


class Timer:
    """Wall-clock timer that waits for device completion on exit."""

    def __init__(self, sync=None):
        self._sync = sync
        self.elapsed_s: Optional[float] = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            jax.block_until_ready(self._sync)
        self.elapsed_s = time.perf_counter() - self._start

    def sync_on(self, value):
        """Register a value to block on before stopping the clock."""
        self._sync = value
        return value


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """jax.profiler trace context (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield


def measure(fn, *args, warmup: int = 1, iters: int = 5, vary=None):
    """Median wall time of a jitted callable; returns (result, seconds).

    Each call ends in ``block_until_ready``, so the clock covers the
    device work, not just the enqueue. ``vary(i, args) -> args``
    produces distinct per-call inputs (e.g. fold the index into the
    RNG key) so every timed call is a fresh solve; the median absorbs
    scheduler jitter.
    """
    import statistics

    result = None
    for i in range(max(warmup, 1)):
        # Warmup indices sit above the timed range (vary hooks may
        # feed the index to jax.random.fold_in, which rejects
        # negative values).
        a = vary(max(iters, 1) + i, args) if vary else args
        result = jax.block_until_ready(fn(*a))
    samples = []
    for i in range(max(iters, 1)):
        a = vary(i, args) if vary else args
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*a))
        samples.append(time.perf_counter() - t0)
    return result, statistics.median(samples)
