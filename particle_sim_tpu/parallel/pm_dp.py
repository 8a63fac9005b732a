"""Multi-device particle-mesh stepping: local deposit -> psum(grid) -> solve.

PM parallelizes differently from the ppermute ring (parallel/ring.py): the
coupling between shards is entirely through the G^3 mass grid, so one
``psum`` of the 8 MB grid over the device interconnect replaces the
ring's n_dev-1 position rotations. Per step, per device:

  1. CIC-deposit the local particle shard onto a full local grid
     (zero-communication: the grid is dense, every shard can reach every
     cell);
  2. ``lax.psum`` the mass grids over the dp axis — the ONLY collective;
  3. solve the FFT Poisson convolution redundantly on every device
     (replicated compute instead of sharded FFTs at G=128: 8 MB of grid
     traffic vs an all-to-all transpose inside every transform);
  4. CIC-gather accelerations for the local shard only.

Communication volume is O(G^3), independent of N — at 16M particles over 4
devices that is 8 MB/step against 4M particle-updates per device.

Global padding is masked by translating the global ``n_active`` into each
shard's local count (shards hold contiguous flat index ranges, so
``clip(n_active - shard_idx * local_n, 0, local_n)``), mirroring the ring's
j_base bookkeeping (ring.py:17-22).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core import params as Pm
from ..ops import physics, pm
from .mesh import DP_AXIS


def _plane_spec() -> P:
    return P(None, DP_AXIS, None)


def make_pm_step(mesh: Mesh, cfg: "Pm.PMConfig", *,
                 with_masses: bool = False, with_base_kernels: bool = False):
    """Jitted (pos, vel, param_vec, pair_vec, n_active[, masses]
    [, base_kernels]) -> (pos, vel).

    pos/vel are (3, R, LANE) planes row-sharded over dp; n_active is the
    GLOBAL active count (replicated scalar). With ``with_masses``, a
    row-sharded f32[capacity] source-mass array scales the local deposits
    (the grid psum makes it global). With ``with_base_kernels`` (static-box
    only), one more trailing argument carries the replicated
    pm.base_kernels_device pairs so the Hockney spectra ride as runtime
    arguments, not program constants."""
    if with_base_kernels and cfg.auto_box:
        raise ValueError("base kernels are for static-box configs (the "
                         "auto_box solve is in traced cell units)")

    def local_step(pos, vel, pv, pairv, n_active, masses=None,
                   base_kernels=None):
        shape = pos.shape
        local_n = shape[1] * shape[2]
        my_idx = jax.lax.axis_index(DP_AXIS)
        local_active = jnp.clip(n_active - my_idx * local_n, 0, local_n)
        flat = pos.reshape(3, -1)

        coords = None
        g_scale = pairv[0]
        cell_size = None
        if cfg.auto_box:
            # global traced box: local extents -> pmin/pmax over dp, then
            # the same cubic-box math as pm.auto_box (cell units solve,
            # 1/h^2 rescale — see pm.pm_accel_ref)
            live = (jnp.arange(local_n, dtype=jnp.int32)
                    < local_active)[None]
            big = jnp.float32(3.0e38)
            lo = jax.lax.pmin(
                jnp.min(jnp.where(live, flat, big), axis=1), DP_AXIS)
            hi = jax.lax.pmax(
                jnp.max(jnp.where(live, flat, -big), axis=1), DP_AXIS)
            size = jnp.maximum(jnp.max(hi - lo) * 1.1, 1e-3)
            box_min = (0.5 * (lo + hi) - 0.5 * size).reshape(3, 1)
            cell = size / cfg.grid
            coords = pm.cell_coords_dyn(flat, box_min, cell, cfg.grid)
            g_scale = pairv[0] / (cell * cell)
            cell_size = 1.0

        rho = pm.cic_deposit_ref(flat, local_active, cfg, coords=coords,
                                 masses=masses)
        rho = jax.lax.psum(rho, DP_AXIS)
        grids = pm.solve_accel(rho, cfg, cfg.softening,
                               cell_size=cell_size, kernels=base_kernels)
        acc = g_scale * pm.cic_gather_ref(grids, flat, cfg, coords=coords)

        # global momentum clean (pm.momentum_clean with a psum'd mean):
        # removes the solver's net-force bias and zeroes clamp-gathered
        # padding in one pass
        live = (jnp.arange(local_n, dtype=jnp.int32)
                < local_active).astype(jnp.float32)
        w = live if masses is None else live * masses
        local_sum = (acc * w[None]).sum(axis=1, keepdims=True)
        global_sum = jax.lax.psum(local_sum, DP_AXIS)
        if masses is None:
            # sum(w) over all shards is just the (replicated) active count
            count = jnp.maximum(n_active.astype(jnp.float32), 1.0)
        else:
            count = jnp.maximum(jax.lax.psum(w.sum(), DP_AXIS), 1e-12)
        acc = (acc - global_sum / count) * live[None]

        return physics.kick_and_step_planes(pos, vel, acc.reshape(shape),
                                            pv)

    def wrapper(pos, vel, pv, pairv, n, *rest):
        masses = rest[0] if with_masses else None
        bk = rest[-1] if with_base_kernels else None
        return local_step(pos, vel, pv, pairv, n, masses, bk)

    sharded = shard_map(
        wrapper,
        mesh=mesh,
        in_specs=(_plane_spec(), _plane_spec(), P(), P(), P())
        + ((P(DP_AXIS),) if with_masses else ())
        + ((P(),) if with_base_kernels else ()),
        out_specs=(_plane_spec(), _plane_spec()),
    )
    return jax.jit(sharded, donate_argnums=(0, 1))
