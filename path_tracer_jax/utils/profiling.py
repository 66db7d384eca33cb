"""Profiling: jax.profiler traces and wall-clock timing of the renderers.

The reference's only timing is a commented-out frame-time printf
(``src/main.c:253-258``). ``trace()`` captures a
TensorBoard-loadable device trace; ``time_fn`` times a jitted call to
completion.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "time_fn"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace around the body."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, warmup: int = 1, iters: int = 3):
    """Median wall time of ``fn(*args)`` after warmup; blocks on results."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
