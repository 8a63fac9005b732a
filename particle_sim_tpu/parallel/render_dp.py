"""Multi-device rendering: per-shard rasterization + ONE framebuffer psum.

The additive premultiplied blend was CHOSEN commutative (render/raster.py
docstring — the reference's own non-premultiplied alpha blend is draw-
order-dependent, i.e. undefined for unsorted points) precisely so partial
framebuffers compose by summation: each shard rasterizes ITS rows of the
row-sharded state with render/raster.py, and one psum of the f32[H, W, 3]
framebuffer composites the frame. Communication is resolution-bound
(24 MB at 1080p), independent of N — the multi-device analog of the wire
mode-2 design (app/server.py).

Clip-to-[0, 1] happens AFTER the psum: clipping per shard first would
darken any pixel whose brightness is split across shards.

Active-count masking: state rows are sharded contiguously (both the
identity order and the per-shard persistent slot order keep each shard's
live particles a storage prefix — parallel/pm_persist_dp.py), so shard k
holds live prefix ``clip(n_active - k*local_n, 0, local_n)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..render import raster
from .mesh import DP_AXIS


def make_render_dp(mesh: Mesh, *, width: int, height: int,
                   flat: bool = False):
    """Jitted (pos, vel, col, param_vec, view_proj, n_active) ->
    f32[height, width, 3] (replicated). ``flat=False`` takes (3, R, LANE)
    component planes row-sharded over dp (the identity-order state
    layout); ``flat=True`` takes (3, N) flat planes sharded over axis 1
    (the persistent carry layout), so the persist render path works
    multi-device without rebuilding identity order."""
    def local(pos, vel, col, pv, vp, n_active):
        local_n = pos.size // 3
        base = jax.lax.axis_index(DP_AXIS) * local_n
        n_loc = jnp.clip(n_active - base, 0, local_n)
        fb = raster.render(pos, vel, col, pv, vp, n_loc,
                           width=width, height=height, clip=False)
        return jnp.clip(jax.lax.psum(fb, DP_AXIS), 0.0, 1.0)

    spec = P(None, DP_AXIS) if flat else P(None, DP_AXIS, None)
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, P(), P(), P()),
        out_specs=P(),
    ))
