"""Profiling & timing utilities — the tracing subsystem (SURVEY.md §5).

The reference's only instrumentation is the FPS window and an EMA of
host-side encode+submit time (``app.rs:209-216,303-315``); GPU timestamps
are unused. The equivalents here:

  * ``trace(logdir)`` — jax.profiler trace capture (open in XProf/
    TensorBoard) around any code block.
  * ``device_time(fn, *args)`` — device-step timing, each call ended
    by ``jax.block_until_ready``.
  * ``marginal_time(fn_n, ...)`` — the dispatch-cancelling methodology used
    by bench.py: time K and K' fused iterations, report the marginal.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple


import jax


def sync(tree) -> None:
    """Wait until every array in ``tree`` is computed."""
    jax.block_until_ready(tree)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time(fn: Callable, *args, reps: int = 3, **kw) -> Tuple[float, object]:
    """Best-of-reps wall time of fn(*args) with completion barriers."""
    out = fn(*args, **kw)
    sync(out)  # warm-up / compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def marginal_time(fn_of_n: Callable[[int], object], n_small: int,
                  n_big: int, reps: int = 5) -> float:
    """Marginal seconds per iteration with dispatch overhead cancelled.

    ``fn_of_n(n)`` must run n fused iterations of the workload (e.g. a
    lax.fori_loop of n steps). Returns (t_big - t_small)/(n_big - n_small).
    When the workload is so small that dispatch jitter swamps the
    difference (t_big <= t_small), falls back to the amortized upper bound
    t_big/n_big instead of reporting a meaningless near-zero marginal.
    """
    t_small, _ = device_time(lambda: fn_of_n(n_small), reps=reps)
    t_big, _ = device_time(lambda: fn_of_n(n_big), reps=reps)
    diff = t_big - t_small
    if diff <= 0:
        return t_big / n_big
    return diff / (n_big - n_small)
