"""Timers and resource tracking (ref: src/utils.rs:55-113).

The reference stamps per-phase timings into the Score record and logs
``[[phase]] k=.. t=..ms`` lines; these helpers back the same behavior plus
optional jax profiler integration.
"""

from __future__ import annotations

import contextlib
import resource
import time
from typing import Callable, Tuple, TypeVar

T = TypeVar("T")


def timer(fn: Callable[[], T]) -> Tuple[T, float]:
    """Run fn, return (result, elapsed milliseconds) (ref: utils.rs:55-79)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1000.0


def timer_us(fn: Callable[[], T]) -> Tuple[T, float]:
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e6


@contextlib.contextmanager
def phase_timer(label: str, verbose: bool = True):
    """``with phase_timer("posterior"):`` logs [[posterior]] t=..ms
    (ref: posterior.rs:744-806 phase timestamps)."""
    t0 = time.perf_counter()
    yield
    if verbose:
        print(f"[[{label}]] t={(time.perf_counter() - t0) * 1000:.0f}ms")


def check_memory_usage() -> float:
    """Peak RSS in MB (ref: utils.rs:88 jemalloc stats)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def edit_distance(a: bytes, b: bytes, band: int = 0) -> int:
    """Levenshtein distance via rolling-row numpy DP (ref: bin/edit_dist.rs).

    ``band > 0`` restricts to a diagonal band (fast approximate lower bound
    for long, similar sequences)."""
    import numpy as np

    if len(a) < len(b):
        a, b = b, a
    n, m = len(a), len(b)
    if m == 0:
        return n
    bn = np.frombuffer(bytes(b), dtype=np.uint8)
    idx = np.arange(1, m + 1, dtype=np.int64)
    prev = np.arange(m + 1, dtype=np.int64)
    for i, ca in enumerate(bytes(a), start=1):
        sub = prev[:-1] + (bn != ca)
        cand = np.minimum(prev[1:] + 1, sub)
        # resolve the left-to-right insert chain cur[j] = min(cand[j],
        # cur[j-1]+1) in closed form: cur[j] = min_{k<=j}(cand[k] + (j-k)),
        # with cand[0-th] boundary = i + 1 - 1 handled by prepending i
        shifted = np.minimum.accumulate(
            np.concatenate(([np.int64(i)], cand)) - np.arange(m + 1)
        )
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        cur[1:] = shifted[1:] + idx
        prev = cur
    return int(prev[-1])


@contextlib.contextmanager
def jax_profile(path: str):
    """Capture a jax profiler trace around a block (device performance analysis)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
