"""Exact short-range forces in a tracked window — the P3M-style
real-space correction, window-bounded instead of screening-bounded.

docs/DESIGN.md's P3M analysis rejected a GLOBAL real-space correction:
the correction range of a mesh-resolvable screening spans hundreds of
interparticle spacings in dense clumps, so a fixed-budget neighbor
scheme wastes 10-50x on empty/far slot pairs. This module takes the
other branch that analysis left open: make the correction EXACT and
confine it to the (tracked) window where it matters — the innermost
refinement region, whose membership fits a static all-pairs budget.

For member pairs (both ends inside the window's margin-shrunk mask) the
correction adds

    Δa_ij = [g(r_ij; eps_exact) − g(r_ij; eps_prev)] · m_j r̂_ij

where ``eps_prev`` is the softening the pair already feels from the
mesh stack (the innermost pm2 level's, or the coarse PM's). Summed with
the mesh field, pairs inside the window feel the EXACT
``eps_exact``-softened force (up to the mesh's own ~2% realization
error of the analytic g(eps_prev) kernel — the same approximation
ops/pm2.py makes at every level); pairs outside keep the mesh force.
Δg decays as r^-5 past eps_prev, so the window-local support loses
only the far tail the mesh already resolves. The correction is
antisymmetric over members by construction (momentum-exact).

Cost: O(B^2) over the member budget — two all-pairs passes
(ops/pairwise_pallas.py's kernel, or the blocked plain-XLA form). The
membership is compacted into a static ``capacity`` buffer by a stable
flag sort (members first) and the correction scattered back; the engine
rejects no frame — overflowing windows just truncate to the first
``capacity`` members by slot order, reported via the returned count so
callers can warn. (On the persistent multi-level order the innermost
class is already a contiguous slot range, so ONE dynamic slice replaces
the flag sort and the scatter — pm_persist.accel_sorted_multi's cfgx
path.)

Reference parity: the reference app has no self-gravity at all
(SURVEY.md §2) — this is a capability extension, tested against the
direct O(N^2) sum at ``eps_exact`` (tests/test_pmx.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import params as P
from . import pairwise as pairwise_jnp
from . import pairwise_pallas, physics, pm, pm2


@dataclass(frozen=True)
class PMXConfig:
    """Exact-force window (all fields static).

    window_size: window extent per axis (world units). Keep the member
                 count within ``capacity`` — the window is meant for the
                 densest core, nested inside the innermost mesh level.
    softening:   eps_exact > 0 — the exact pair softening inside the
                 window; must be < the innermost mesh softening (the
                 difference split, as pm2._validate_levels).
    capacity:    static member budget B of the all-pairs buffer
                 (multiple of 512).
    margin:      shrink of the member mask inside the window (world
                 units), as pm2.PM2Config.margin.
    window_min:  static origin, or None to track the parent level's
                 member centroid (pm2._nested_wmins semantics — the
                 same attribute set lets PMXConfig ride that chain).
    """
    window_size: float
    softening: float
    capacity: int = 65536
    margin: float = 0.0
    window_min: Optional[Tuple[float, float, float]] = None
    # pm2._nested_wmins reads .park via the repair path only; harmless
    # default for attribute parity with PM2Config consumers
    park: float = 1.0

    def __post_init__(self):
        if self.capacity % 512:
            raise ValueError(
                f"pmx capacity {self.capacity} not a multiple of 512")
        if self.softening <= 0.0:
            raise ValueError("pmx needs softening > 0 (a pure 1/r^2 "
                             "force diverges at CIC-coincident points)")


def _member_mask(pos_flat, wmin, cfgx: PMXConfig, live):
    return pm2._in_window(pos_flat, wmin, cfgx.window_size,
                          cfgx.margin) & live


def exact_accel_ref(pos_flat: jax.Array, live: jax.Array,
                    cfgx: PMXConfig, eps_prev: float, *, masses=None,
                    wmin=None, psum_axis=None) -> jax.Array:
    """f32[3, N] window-exact correction — jnp oracle (O(N^2) memory;
    small-N tests). Member pairs feel g(eps_exact) − g(eps_prev)."""
    if wmin is None:
        wmin = pm2.window_min(pos_flat, None, cfgx, masses, live=live,
                              psum_axis=psum_axis)
    w = _member_mask(pos_flat, wmin, cfgx, live).astype(jnp.float32)
    m_src = w if masses is None else w * masses
    a_x = pairwise_jnp.pairwise_accel(pos_flat, pos_flat.shape[1], 1.0,
                                      cfgx.softening, masses=m_src)
    a_p = pairwise_jnp.pairwise_accel(pos_flat, pos_flat.shape[1], 1.0,
                                      eps_prev, masses=m_src)
    return (a_x - a_p) * w[None]


def pair_accel(use_kernel: bool, interpret: bool = False):
    """The all-pairs function of the exact window: the Triton kernel
    (ops/pairwise_pallas.py) or the blocked plain-XLA form, with the
    same signature (receivers f32[3, Ni], sources f32[3, Nj], n_active,
    G, softening, masses=...)."""
    if use_kernel:
        return functools.partial(pairwise_pallas.pairwise_accel,
                                 interpret=interpret)
    return pairwise_jnp.pairwise_accel_blocked


def exact_accel(pos_flat: jax.Array, live: jax.Array, cfgx: PMXConfig,
                eps_prev: float, *, masses=None, wmin=None,
                use_kernel: bool = False, interpret: bool = False,
                psum_axis=None) -> Tuple[jax.Array, jax.Array]:
    """(corr f32[3, N], n_members i32) — compact-buffer path.

    Members are compacted (stable flag sort, members-first) into a
    static ``cfgx.capacity`` buffer; two all-pairs passes (pair_accel)
    compute the difference field, which is scattered back by the carried
    index. Members past the capacity are dropped from the correction
    (they keep the pure mesh force) — the returned count lets callers
    warn.

    ``psum_axis``: NOT supported (the compact buffer is shard-local, so
    cross-shard member pairs would be missed) — multi-device callers use
    exact_accel_ref semantics via an all-gather, or keep pmx
    single-device; the engine enforces this.
    """
    if psum_axis is not None:
        raise NotImplementedError(
            "pmx compact path is single-device (shard-local compaction "
            "would miss cross-shard member pairs)")
    n = pos_flat.shape[1]
    B = min(cfgx.capacity, n)
    if wmin is None:
        wmin = pm2.window_min(pos_flat, None, cfgx, masses, live=live)
    member = _member_mask(pos_flat, wmin, cfgx, live)
    n_m = member.sum().astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    flag = jnp.where(member, jnp.int32(0), jnp.int32(1))
    ops = (flag, idx, pos_flat[0], pos_flat[1], pos_flat[2])
    if masses is not None:
        ops += (masses,)
    s = jax.lax.sort(ops, num_keys=1)          # stable: members first
    idx_s = s[1]
    buf = jnp.stack(s[2:5])[:, :B]             # f32[3, B]
    in_budget = jnp.arange(B, dtype=jnp.int32) < jnp.minimum(n_m, B)
    m_buf = in_budget.astype(jnp.float32)
    if masses is not None:
        m_buf = m_buf * s[5][:B]
    accel = pair_accel(use_kernel, interpret)
    a_x = accel(buf, buf, B, 1.0, cfgx.softening, masses=m_buf)
    a_p = accel(buf, buf, B, 1.0, eps_prev, masses=m_buf)
    corr_buf = (a_x - a_p) * in_budget[None].astype(jnp.float32)
    corr = jnp.zeros((3, n), jnp.float32).at[:, idx_s[:B]].set(corr_buf)
    return corr, n_m


def _eps_prev(cfg: "P.PMConfig", levels) -> float:
    return float(levels[-1].softening) if levels else float(cfg.softening)


def _validate(cfg: "P.PMConfig", levels, cfgx: PMXConfig) -> None:
    ep = _eps_prev(cfg, levels)
    if cfgx.softening >= ep:
        raise ValueError(
            f"pmx softening {cfgx.softening} must be < the innermost "
            f"mesh softening ({ep}) for the difference split")
    parent_size = (float(levels[-1].window_size) if levels
                   else float(cfg.box_size))
    parent_margin = float(levels[-1].margin) if levels else 0.0
    if cfgx.window_size > parent_size - 2.0 * parent_margin:
        raise ValueError(
            f"pmx window {cfgx.window_size} cannot nest inside the "
            f"innermost mesh level (usable extent "
            f"{parent_size - 2.0 * parent_margin})")


def pmx_accel(pos_flat: jax.Array, n_active, g_const, cfg: "P.PMConfig",
              levels, cfgx: PMXConfig, *, masses=None, kernels=None,
              base_kernels=None, use_kernel: bool = False,
              interpret: bool = False) -> Tuple[jax.Array, jax.Array]:
    """(acc f32[3, N], n_members) — full stack: coarse PM + the pm2
    refinement levels (possibly empty) + the window-exact correction.
    ``levels`` is () or a tuple of PM2Config (outermost first);
    ``kernels`` = pm2.levels_kernels(cfg, levels) when non-empty.
    ``use_kernel`` runs the window's all-pairs passes on the Triton
    kernel (``interpret`` runs it in the Pallas interpreter)."""
    levels = tuple(levels) if levels else ()
    _validate(cfg, levels, cfgx)
    n = pos_flat.shape[1]
    live = jnp.arange(n, dtype=jnp.int32) < n_active
    if levels:
        acc = pm2.pmn_accel_ref(pos_flat, n_active, 1.0, cfg, levels,
                                masses=masses, kernels=kernels,
                                base_kernels=base_kernels)
        wmins = pm2._nested_wmins(pos_flat, live, cfg, levels, masses)
        # the exact window tracks the innermost mesh level's members
        lv_live = (pm2._in_window(pos_flat, wmins[-1],
                                  levels[-1].window_size,
                                  levels[-1].margin) & live)
        wmin = pm2.window_min(pos_flat, None, cfgx, masses, live=lv_live)
        wmin = jnp.clip(
            wmin, wmins[-1] + jnp.float32(levels[-1].margin),
            wmins[-1] + jnp.float32(levels[-1].window_size
                                    - levels[-1].margin
                                    - cfgx.window_size))
    else:
        acc = pm.pm_accel_ref(pos_flat, n_active, 1.0, cfg.softening,
                              cfg, masses=masses, kernels=base_kernels)
        wmin = pm2.window_min(pos_flat, None, cfgx, masses, live=live)
    ep = _eps_prev(cfg, levels)
    # the exact correction always runs the compact-buffer path
    # (exact_accel_ref's [3, N, N] broadcast is a small-N test oracle)
    corr, n_m = exact_accel(pos_flat, live, cfgx, ep, masses=masses,
                            wmin=wmin, use_kernel=use_kernel,
                            interpret=interpret)
    acc = acc + corr
    return g_const * pm.momentum_clean(acc, n_active, masses), n_m


def step_pmx(pos: jax.Array, vel: jax.Array, param_vec: jax.Array,
             pair_vec: jax.Array, n_active, cfg: "P.PMConfig", levels,
             cfgx: PMXConfig, *, masses=None, kernels=None,
             base_kernels=None, use_kernel: bool = False,
             interpret: bool = False
             ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One frame: mesh stack + window-exact correction + the reference
    kick/step contract — same plane contract as pm.step_pm_ref, plus
    the window member count as a third output so the engine can surface
    capacity truncation (a count nobody reads is not loud)."""
    flat = pos.reshape(3, -1)
    acc, n_m = pmx_accel(flat, n_active, pair_vec[0], cfg, levels, cfgx,
                         masses=masses, kernels=kernels,
                         use_kernel=use_kernel,
                         base_kernels=base_kernels, interpret=interpret)
    pos2, vel2 = physics.kick_and_step_planes(
        pos, vel, acc.reshape(pos.shape), param_vec)
    return pos2, vel2, n_m


@functools.partial(jax.jit, static_argnames=(
    "cfg", "levels", "cfgx", "use_kernel", "interpret"))
def step_pmx_jit(pos, vel, param_vec, pair_vec, n_active, cfg, levels,
                 cfgx, use_kernel: bool = False, interpret: bool = False,
                 masses=None, kernels=None, base_kernels=None):
    return step_pmx(pos, vel, param_vec, pair_vec, n_active, cfg, levels,
                    cfgx, masses=masses, kernels=kernels,
                    base_kernels=base_kernels,
                    use_kernel=use_kernel, interpret=interpret)
