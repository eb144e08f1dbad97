"""Profiling helpers.

The reference exposes device-event timing (``AbstractEvent.time_since``,
profiled command queues — reference: abc.py:82-95, opencl.py:630-656) for
manual kernel timing, plus ``-lineinfo`` source mapping for vendor
profilers (cuda.py:48-51).  The JAX equivalents (SURVEY.md §5):

* :func:`time_samples` / :func:`time_fn` — wall-clock windows around
  ``block_until_ready`` (the analogue of the tuning queues' event pairs);
* :func:`trace` — a context manager around ``jax.profiler`` emitting a
  TensorBoard/Perfetto trace, where XLA kernels appear with their
  Python source attribution (the ``#line`` analogue is built into JAX).
"""

import contextlib
import time
from typing import Callable

import jax
import numpy as np


def time_samples(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> np.ndarray:
    """Seconds of each of `iters` calls of `fn`, after `warmup` untimed calls.

    Every call is waited for with ``block_until_ready`` inside its own
    window, so a window is the host's view of one complete call: dispatch
    plus device time.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = np.empty(iters)
    for i in range(iters):
        start = time.perf_counter()
        jax.block_until_ready(fn())
        times[i] = time.perf_counter() - start
    return times


def time_fn(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """Median seconds per call of `fn` (see :func:`time_samples`)."""
    return float(np.median(time_samples(fn, iters, warmup)))


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a device trace under `log_dir` (view with TensorBoard/Perfetto)."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Name a region in the profiler timeline (TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield
