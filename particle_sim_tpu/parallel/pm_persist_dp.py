"""Multi-device persistent cell-ordered particle-mesh stepping.

The composition of parallel/pm_dp.py's communication pattern (shards
couple ONLY through one psum of the mass grid; the FFT solve is computed
redundantly per device; gathers are local) with ops/pm_persist.py's
sort-free steady-state frames: each shard keeps ITS OWN locally
cell-sorted slice of the particles, with GLOBAL identity riding in
``ids``. Particles never migrate between shards — locality of the
storage order is a per-shard property — so repairs (the lax.cond full
sort in pm_persist.accel_sorted) fire per shard independently and touch
no collective. Communication per step stays exactly one O(G^3) grid
psum + two scalar psums (momentum clean), independent of N.

State layout across the mesh: pos/vel f32[3, N] sharded over axis 1,
ids i32[N] sharded (values are global identities), resorts i32[n_dev]
(one per-shard repair counter; sharded so each shard owns its own).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core import params as Pm
from ..ops import pm_persist
from .mesh import DP_AXIS


def _flat_spec() -> P:
    return P(None, DP_AXIS)


def make_persist_init(mesh: Mesh, cfg: "Pm.PMConfig", *,
                      with_masses: bool = False, with_col: bool = False,
                      n_levels: int = 0):
    """Jitted (pos f32[3,N], vel f32[3,N], n_active[, masses][, col24])
    -> (pos, vel, ids, resorts, fine_b[, masses][, col24]) — per-shard
    local grouping sorts into the persistent layout (fine_b i32[n_dev]:
    each shard's frozen fine-segment boundary, local_n = none yet;
    with ``n_levels`` > 0, i32[n_dev, n_levels] — the MULTI-level class
    boundaries, pm_persist.accel_sorted_multi).
    N/n_dev must be a multiple of 512. ``col24`` is the packed display
    color (pm_persist.SortedPMState), sharded like masses."""
    n_dev = mesh.devices.size

    def local(pos, vel, n_active, *rest):
        masses = rest[0] if with_masses else None
        col24 = rest[-1] if with_col else None
        local_n = pos.shape[1]
        base = jax.lax.axis_index(DP_AXIS) * local_n
        ids = base + jnp.arange(local_n, dtype=jnp.int32)
        key = pm_persist.cell_key(pos, ids < n_active, cfg)
        fb_shape = (1, n_levels) if n_levels else (1,)
        st = pm_persist._sort_state(key, pos, vel, ids, masses,
                                    jnp.zeros((1,), jnp.int32),
                                    jnp.full(fb_shape, local_n, jnp.int32),
                                    col24)
        out = (st.pos, st.vel, st.ids, st.resorts, st.fine_b)
        out += (st.masses,) if masses is not None else ()
        return out + ((st.col24,) if col24 is not None else ())

    extra_in = ((P(DP_AXIS),) if with_masses else ()) + (
        (P(DP_AXIS),) if with_col else ())
    extra_out = extra_in
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(_flat_spec(), _flat_spec(), P()) + extra_in,
        out_specs=(_flat_spec(), _flat_spec(), P(DP_AXIS), P(DP_AXIS),
                   P(DP_AXIS)) + extra_out,
        check_vma=False,  # cell_key mixes literal iotas into varying
    ))                    # data (see parallel/dp.py for the JAX 0.9 note)


def make_persist_pm_step(mesh: Mesh, cfg: "Pm.PMConfig", *,
                         use_kernel: bool = False, interpret: bool = False,
                         chunk: int = 0,
                         with_masses: bool = False, with_col: bool = False,
                         cfg2=None, cfgx=None, two_tier: bool = True,
                         with_base_kernels: bool = False):
    """Jitted (pos, vel, ids, resorts, fine_b, param_vec, pair_vec,
    n_active[, masses][, col24][, kernels]) -> (pos, vel, ids, resorts,
    fine_b[, masses][, col24][, pmx_counts]): one
    persistent-PM frame over the dp mesh. Arrays as in
    make_persist_init; n_active is the GLOBAL active count (ids are
    global, so ``ids < n_active`` masks correctly on every shard with no
    local-count bookkeeping). ``cfg2`` (pm2.PM2Config) adds the
    two-level refinement — the fine grid joins the coarse grid's psum
    coupling and the window origin is global (ops/pm_persist.py
    accel_sorted docstring); pass pm2.fine_kernels(cfg, cfg2) as the
    trailing ``kernels`` argument (replicated). A TUPLE ``cfg2`` runs
    the MULTI-level k+1-class order (pm_persist.accel_sorted_multi;
    fine_b is then i32[n_dev, k]) with pm2.levels_kernels as
    ``kernels``. ``cfgx`` (a pmx.PMXConfig; needs a tuple ``cfg2``)
    terminates the stack with the window-exact correction — each shard
    contributes capacity/n_dev slots of its innermost class to one
    all_gather'd global member buffer (accel_sorted_multi docstring);
    the output gains a replicated i32[2] (n_members, n_corrected);
    ``use_kernel`` runs its all-pairs passes on the Triton kernel.
    ``two_tier=False`` forces every per-shard repair straight to the
    full local sort (see pm_persist.accel_sorted).
    ``with_base_kernels=True`` appends one more trailing argument — the
    replicated pm.base_kernels_device(...) pairs — routing the coarse
    Hockney kernels in as runtime arguments instead of baked program
    constants (pm.base_kernels_device docstring)."""
    if cfgx is not None and not isinstance(cfg2, tuple):
        raise ValueError("multi-device pmx rides the MULTI-level class "
                         "order — pass a tuple cfg2")
    n_dev = int(mesh.devices.size)

    def local(pos, vel, ids, resorts, fine_b, pv, pairv, n_active,
              *rest):
        masses = rest[0] if with_masses else None
        col24 = rest[int(with_masses)] if with_col else None
        base_kernels = rest[-1] if with_base_kernels else None
        kern_i = -2 if with_base_kernels else -1
        kernels = rest[kern_i] if cfg2 is not None else None
        st = pm_persist.SortedPMState(pos, vel, ids, masses, resorts[0],
                                      fine_b[0], col24)
        out = pm_persist.step_sorted(st, pv, pairv, n_active, cfg,
                                     use_kernel=use_kernel,
                                     interpret=interpret, chunk=chunk,
                                     psum_axis=DP_AXIS, cfg2=cfg2,
                                     kernels=kernels,
                                     base_kernels=base_kernels, cfgx=cfgx,
                                     pmx_shards=n_dev, two_tier=two_tier)
        st, counts = out if cfgx is not None else (out, None)
        res = (st.pos, st.vel, st.ids, st.resorts[None], st.fine_b[None])
        res += (st.masses,) if masses is not None else ()
        res += (st.col24,) if col24 is not None else ()
        return res + ((counts,) if cfgx is not None else ())

    extra = ((P(DP_AXIS),) if with_masses else ()) + (
        (P(DP_AXIS),) if with_col else ())
    ker_in = ((P(),) if cfg2 is not None else ()) + (
        (P(),) if with_base_kernels else ())
    counts_out = (P(),) if cfgx is not None else ()
    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(_flat_spec(), _flat_spec(), P(DP_AXIS), P(DP_AXIS),
                  P(DP_AXIS), P(), P(), P()) + extra + ker_in,
        out_specs=(_flat_spec(), _flat_spec(), P(DP_AXIS), P(DP_AXIS),
                   P(DP_AXIS)) + extra + counts_out,
        check_vma=False,  # cell_key iotas / Pallas bodies (parallel/dp.py)
    )
    return jax.jit(sharded, donate_argnums=(0, 1))
