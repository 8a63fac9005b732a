"""Vectorized binary search via gathers.

A fixed-iteration bisection: a handful of fused gathers with a static trip
count, where ``jnp.searchsorted`` lowers to per-probe loops. Used by the
persistent PM order's disorder measure (ops/pm_persist.py _hull).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bin_search(sorted_arr: jax.Array, probes: jax.Array, side_right: bool,
               n_iters: int) -> jax.Array:
    """First index i with sorted_arr[i] >= probe (side_right=False,
    numpy side='left') or > probe (side_right=True, side='right').

    Runs a FIXED iteration count, so it must stay stable after
    convergence: when lo == hi == n (probe beyond every element) the
    clipped read sees sorted_arr[n-1] < probe and a naive update would
    push lo past n on every extra iteration — out-of-range results that
    double chunk-table entries downstream. ``mid < n`` gates the
    right-move (an out-of-range mid acts as +inf).
    """
    n = sorted_arr.shape[0]
    lo = jnp.zeros_like(probes)
    hi = jnp.full_like(probes, n)
    for _ in range(n_iters):
        mid = (lo + hi) // 2
        v = sorted_arr[jnp.clip(mid, 0, n - 1)]
        go_right = ((mid < n)
                    & jnp.where(side_right, v <= probes, v < probes))
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo

