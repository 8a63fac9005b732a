"""Two-level particle-mesh — sub-mesh-scale forces via a refinement window.

The single-level PM (ops/pm.py) resolves forces down to
its softening, which mesh accuracy pins at eps >= ~2-3 cells of the WORLD
grid — dense clumps smaller than a few cells feel only their smoothed
far field. The reference app has no self-gravity at all, so this is a
capability extension past docs/DESIGN.md's P3M analysis, which found a
global pairwise short-range correction wasting 10-50x on empty slot
pairs in dense clumps; the route it names — a multi-level mesh — is
what this module builds:

  * **Coarse level**: the ordinary PM over the full box, softened at
    eps1 = cfg.softening (>= ~2.5 h1 for mesh accuracy). Every particle
    gets this far field.
  * **Fine level**: a second GRID^3 mesh over a refinement window (a
    sub-box around the region of interest, h2 = window/grid cells).
    It deposits ONLY the particles inside the window and solves the
    isolated Hockney convolution with the DIFFERENCE kernel
    g_eps - g_eps1 (pm.solve_accel_diff) — exactly the short-range part
    the coarse level smoothed away, decaying like r^-4 beyond eps1 so
    its support is local.
  * **Composition**: the SAME window mask selects sources and
    receivers, so the correction acts exactly on window-internal pairs
    and is antisymmetric — zero net force by construction (a one-sided
    mask was measured to leak its imbalance through momentum_clean as a
    constant ~7% error vector on off-center clumps). Window particles
    get coarse + fine = the eps-softened force from window sources and
    the eps1 force from outside sources (pairs straddling the window
    edge stay at eps1 on BOTH sides); everything outside keeps the
    coarse field untouched. Effective refinement is therefore
    1/(window/box)x where it matters, for one extra O(G^3 log G)
    solve.

Both levels run on the same machinery (pm.cic_deposit / solve / gather,
the window's cell coords and the window mask riding as the deposit
weight): one extra deposit + solve + gather per frame. The persistent
cell-ordered state (ops/pm_persist.py) runs the same composition on its
slot order.

**Multi-level** (pmn_accel_ref): the construction nests to
any depth — level k solves the difference kernel
g_eps_k - g_eps_{k-1} over window_k (clamped inside window_{k-1}'s
source mask), so the composite telescopes: pairs inside the innermost
window containing them feel that level's softening. Auto-tracking
origins zoom recursively (each level's centroid is taken over the
PARENT level's members), giving effective refinement
prod_k(window_{k-1}/window_k) at the densest substructure for one
extra O(G^3 log G) solve per level. The two-level functions are the
one-level case.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import params as P
from . import physics, pm


@dataclass(frozen=True)
class PM2Config:
    """Fine-level configuration (all static — shapes cached kernel FFTs).

    window_min:  world coords of the refinement window origin, or None
                 to TRACK the live mass centroid every step (the window
                 follows a collapsing/drifting clump; only the origin is
                 traced — the size, and with it the cached kernel FFTs,
                 stays static).
    window_size: window extent per axis (fine cell h2 = window_size/grid;
                 the grid resolution is inherited from the coarse
                 PMConfig).
    softening:   fine Plummer eps — resolve eps >= ~2.5 h2; must be
                 < the coarse cfg.softening for the split to make sense.
    margin:      optional shrink (world units) of the correction mask
                 inside the window (both sources and receivers). The
                 scheme is momentum-exact at any margin; particles
                 within ~2 eps1 of the mask edge see intermediate
                 accuracy (their just-outside neighbors stay
                 eps1-softened). Default 0 = the whole window.
    gradient:    'exact' or 'fd', as in PMConfig.
    park:        width (world units) of the PARKING band the persistent
                 two-level mode (ops/pm_persist.py) adds OUTSIDE the
                 source mask when freezing window membership at repair
                 time: a particle must drift across the band before it
                 can enter the source set, so membership staleness never
                 affects physics — it only sets how often a true entrant
                 forces a repair sort. Irrelevant to the per-frame paths.
    """
    window_min: Optional[Tuple[float, float, float]]
    window_size: float
    softening: float
    margin: float = 0.0
    gradient: str = "exact"
    park: float = 1.0


def _in_window(pos_flat: jax.Array, wmin: jax.Array, size: float,
               shrink: float) -> jax.Array:
    lo = wmin.reshape(3, 1) + jnp.float32(shrink)
    hi = lo + jnp.float32(size - 2.0 * shrink)
    return ((pos_flat >= lo) & (pos_flat < hi)).all(axis=0)


def window_min(pos_flat: jax.Array, n_active: jax.Array,
               cfg2: PM2Config, masses=None, live=None,
               psum_axis=None) -> jax.Array:
    """f32[3] window origin: the static config value, or (auto mode) the
    live mass centroid minus half the window. ``live`` (bool[N])
    overrides the ``arange < n_active`` liveness for callers in
    non-identity slot order (ops/pm_persist.py). Inside a shard_map,
    ``psum_axis`` makes the centroid GLOBAL (one psum of 4 scalars) so
    every shard agrees on the window. Order-invariant: a re-sort of the
    same particle set yields the same origin."""
    if cfg2.window_min is not None:
        return jnp.asarray(cfg2.window_min, jnp.float32)
    n = pos_flat.shape[1]
    if live is None:
        live = jnp.arange(n, dtype=jnp.int32) < n_active
    w = live.astype(jnp.float32)
    if masses is not None:
        w = w * masses
    s = (pos_flat * w[None]).sum(axis=1)
    tot = w.sum()
    if psum_axis is not None:
        s, tot = jax.lax.psum((s, tot), psum_axis)
    c = s / jnp.maximum(tot, 1e-12)
    return c - 0.5 * jnp.float32(cfg2.window_size)


def fine_kernels(cfg: "P.PMConfig", cfg2: PM2Config,
                 eps_outer: Optional[float] = None) -> tuple:
    """Device-resident difference kernels for the fine solve — pass into
    pm2_accel_ref/step_pm2_jit as the ``kernels`` argument when calling
    under jit (pm.diff_kernels_device explains why).
    ``eps_outer`` defaults to the coarse softening; deeper levels of the
    multi-level solver (pmn_accel_ref) pass the PARENT level's softening."""
    h2 = cfg2.window_size / cfg.grid
    eo = cfg.softening if eps_outer is None else eps_outer
    return pm.diff_kernels_device(cfg.grid, h2, cfg2.softening,
                                  eo, cfg2.gradient)


def levels_kernels(cfg: "P.PMConfig", levels) -> tuple:
    """Per-level device kernels for pmn_accel_ref: level k's difference
    kernel subtracts the PREVIOUS level's softening (telescoping)."""
    out, eps_outer = [], cfg.softening
    for c2 in levels:
        out.append(fine_kernels(cfg, c2, eps_outer=eps_outer))
        eps_outer = c2.softening
    return tuple(out)


def fine_accel(pos_flat: jax.Array, live: jax.Array,
               cfg: "P.PMConfig", cfg2: PM2Config, *, masses=None,
               kernels=None, wmin=None, psum_axis=None,
               eps_outer: Optional[float] = None) -> jax.Array:
    """f32[3, N] fine-level (difference-kernel) acceleration in the
    CALLER's slot order, already masked to window-internal receivers.
    ``live`` is an explicit bool[N] (identity order passes
    ``arange < n_active``; the persistent state passes
    ``ids < n_active``, ops/pm_persist.py).

    Particles outside the window clamp to the window boundary with
    deposit weight zero (the window mask rides as the deposit weight) and
    their gathered values are masked by the same window test.
    ``eps_outer`` defaults to the coarse softening (two-level mode);
    deeper levels of the multi-level solver pass the PARENT level's.
    ``wmin`` overrides the window origin (callers that already computed a
    global one); ``psum_axis`` (shard_map) makes the origin global and
    psums the fine mass grid before the replicated solve — the same
    one-grid-psum coupling as the coarse level (parallel/pm_dp.py)."""
    if wmin is None:
        wmin = window_min(pos_flat, None, cfg2, masses, live=live,
                          psum_axis=psum_axis)
    h2 = cfg2.window_size / cfg.grid
    eo = cfg.softening if eps_outer is None else eps_outer
    coords2 = pm.cell_coords_dyn(pos_flat, wmin, h2, cfg.grid)
    w_src = (_in_window(pos_flat, wmin, cfg2.window_size, cfg2.margin)
             & live).astype(jnp.float32)
    m_src = w_src if masses is None else w_src * masses
    rho2 = pm.cic_deposit(coords2, m_src, cfg.grid)
    if psum_axis is not None:
        rho2 = jax.lax.psum(rho2, psum_axis)
    grids2 = pm.solve_accel_diff(rho2, cfg.grid, h2, cfg2.softening,
                                 eo, cfg2.gradient, kernels=kernels)
    # receivers == sources: window-internal pairs only (antisymmetric)
    return pm.cic_gather(grids2, coords2, cfg.grid) * w_src[None]


def pm2_accel_ref(pos_flat: jax.Array, n_active: jax.Array, g_const,
                  cfg: "P.PMConfig", cfg2: PM2Config,
                  masses=None, kernels=None,
                  base_kernels=None) -> jax.Array:
    """f32[3, N] two-level PM acceleration (the one-level case of
    pmn_accel_ref; receivers == sources, so the correction acts on
    window-internal pairs only and is antisymmetric)."""
    return pmn_accel_ref(pos_flat, n_active, g_const, cfg, (cfg2,),
                         masses=masses, base_kernels=base_kernels,
                         kernels=None if kernels is None else (kernels,))


# ---------------------------------------------------------------------------
# multi-level nesting (k refinement windows, outermost first)
# ---------------------------------------------------------------------------

def _validate_levels(cfg: "P.PMConfig", levels) -> tuple:
    """Static nesting checks: each level's softening strictly below its
    parent's (the difference split needs eps_k < eps_{k-1}) and each
    window small enough to fit inside the parent's margin-shrunk source
    mask (so the traced origin clamp in _nested_wmins can always nest),
    all inside a static coarse box."""
    levels = tuple(levels)
    if not levels:
        raise ValueError("need at least one refinement level")
    if cfg.auto_box:
        # the windows and their softenings are in world units; an
        # auto-box coarse level solves in cell units of a moving box
        raise ValueError("refinement levels need a static coarse box")
    prev_size = float(cfg.box_size)
    prev_eps = float(cfg.softening)
    prev_margin = 0.0
    for k, c2 in enumerate(levels):
        if c2.softening >= prev_eps:
            raise ValueError(
                f"level {k} softening {c2.softening} must be < the level "
                f"above ({prev_eps}) for the difference-kernel split")
        if c2.window_size > prev_size - 2.0 * prev_margin:
            raise ValueError(
                f"level {k} window {c2.window_size} cannot nest inside "
                f"the level above (usable extent "
                f"{prev_size - 2.0 * prev_margin})")
        prev_size = float(c2.window_size)
        prev_eps = float(c2.softening)
        prev_margin = float(c2.margin)
    return levels


def _nested_wmins(pos_flat, live, cfg, levels, masses, psum_axis=None):
    """Per-level window origins, each nested inside the level above.

    Auto origins (window_min=None) track the mass centroid of the
    PARENT level's members — successive levels zoom into the densest
    substructure — and are clamped so window_k stays inside level
    k-1's margin-shrunk source mask (required for the telescoping
    composition: a pair corrected at level k must already be corrected
    at level k-1). Static child origins under a static parent are
    validated eagerly; under a TRACED parent they are clamped like auto
    ones (the clamp is an identity whenever the static window already
    nests)."""
    wmins = []
    lv_live = live
    prev = None
    for k, c2 in enumerate(levels):
        w = window_min(pos_flat, None, c2, masses, live=lv_live,
                       psum_axis=psum_axis)
        if prev is not None:
            pw, pc = prev
            if c2.window_min is not None and pc.window_min is not None:
                lo = np.asarray(pc.window_min, np.float64) + pc.margin
                hi = lo + (pc.window_size - 2.0 * pc.margin
                           - c2.window_size)
                cw = np.asarray(c2.window_min, np.float64)
                if (cw < lo - 1e-6).any() or (cw > hi + 1e-6).any():
                    raise ValueError(
                        f"level {k} static window {c2.window_min} does "
                        f"not nest inside level {k - 1}'s source mask "
                        f"[{tuple(lo)}, {tuple(hi)}]")
            else:
                w = jnp.clip(
                    w, pw + jnp.float32(pc.margin),
                    pw + jnp.float32(pc.window_size - pc.margin
                                     - c2.window_size))
        wmins.append(w)
        lv_live = _in_window(pos_flat, w, c2.window_size, c2.margin) & live
        prev = (w, c2)
    return wmins


def pmn_accel_ref(pos_flat: jax.Array, n_active: jax.Array, g_const,
                  cfg: "P.PMConfig", levels, masses=None,
                  kernels=None, base_kernels=None) -> jax.Array:
    """f32[3, N] MULTI-level PM acceleration.

    ``levels``: nested refinement windows (PM2Config), outermost first.
    Level k solves the isolated Hockney convolution with the difference
    kernel g_eps_k - g_eps_{k-1} over window_k's sources and receivers,
    so the composition telescopes: a pair whose two ends lie inside
    window_k feels exactly the eps_k-softened force, down to the
    innermost window that contains it. One extra O(G^3 log G) solve per
    level; effective spatial refinement multiplies per level. With one
    level this is exactly pm2_accel_ref. ``kernels``: optional
    levels_kernels(cfg, levels) output and ``base_kernels`` the coarse
    pm.base_kernels_device pairs (jit-argument kernels)."""
    levels = _validate_levels(cfg, levels)
    acc = pm.pm_accel_ref(pos_flat, n_active, 1.0, cfg.softening, cfg,
                          masses=masses, kernels=base_kernels)
    n = pos_flat.shape[1]
    live = jnp.arange(n, dtype=jnp.int32) < n_active
    wmins = _nested_wmins(pos_flat, live, cfg, levels, masses)
    eps_outer = cfg.softening
    for k, (c2, w) in enumerate(zip(levels, wmins)):
        ker = None if kernels is None else kernels[k]
        acc = acc + fine_accel(pos_flat, live, cfg, c2, masses=masses,
                               kernels=ker, wmin=w, eps_outer=eps_outer)
        eps_outer = float(c2.softening)
    return g_const * pm.momentum_clean(acc, n_active, masses)


def step_pmn(pos: jax.Array, vel: jax.Array, param_vec: jax.Array,
             pair_vec: jax.Array, n_active: jax.Array, cfg: "P.PMConfig",
             levels, *, masses=None, kernels=None,
             base_kernels=None) -> Tuple[jax.Array, jax.Array]:
    """One frame: multi-level PM self-gravity + attractor step on
    (3, R, LANE) planes — same contract as pm.step_pm_ref."""
    flat = pos.reshape(3, -1)
    acc = pmn_accel_ref(flat, n_active, pair_vec[0], cfg, levels,
                        masses=masses, kernels=kernels,
                        base_kernels=base_kernels)
    return physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                        param_vec)


@functools.partial(jax.jit, static_argnames=("cfg", "levels"))
def step_pmn_jit(pos, vel, param_vec, pair_vec, n_active, cfg, levels,
                 masses=None, kernels=None, base_kernels=None):
    return step_pmn(pos, vel, param_vec, pair_vec, n_active, cfg, levels,
                    masses=masses, kernels=kernels,
                    base_kernels=base_kernels)


def step_pm2(pos: jax.Array, vel: jax.Array, param_vec: jax.Array,
             pair_vec: jax.Array, n_active: jax.Array, cfg: "P.PMConfig",
             cfg2: PM2Config, *, masses=None, kernels=None,
             base_kernels=None) -> Tuple[jax.Array, jax.Array]:
    """One frame: two-level PM self-gravity + attractor step on
    (3, R, LANE) planes — same contract as pm.step_pm_ref."""
    return step_pmn(pos, vel, param_vec, pair_vec, n_active, cfg, (cfg2,),
                    masses=masses, base_kernels=base_kernels,
                    kernels=None if kernels is None else (kernels,))


@functools.partial(jax.jit, static_argnames=("cfg", "cfg2"))
def step_pm2_jit(pos, vel, param_vec, pair_vec, n_active, cfg, cfg2,
                 masses=None, kernels=None, base_kernels=None):
    return step_pm2(pos, vel, param_vec, pair_vec, n_active, cfg, cfg2,
                    masses=masses, kernels=kernels,
                    base_kernels=base_kernels)
