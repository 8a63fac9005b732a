"""Particle state: SoA component planes resident in device memory.

The reference stores particles as an interleaved array of 64-byte AoS structs
(``src/simulation/mod.rs:86-98``: position vec3 + pad,
velocity vec3 + pad, color vec4, initial_color vec4) used simultaneously as a
STORAGE and VERTEX buffer. That layout is a vertex-fetch artifact; here it
would waste memory bandwidth on padding and on strided component loads.

Layout decisions:
  * **SoA component planes** shaped ``float32[3, R, LANE]`` with
    ``LANE = 128`` and padded capacity ``R * 128`` — each component is one
    contiguous plane, so elementwise steps read and write coalesced rows,
    and the kernels see the flattened ``(3, N)`` view of the same memory.
  * **No stored current color.** The per-frame color (``compute.wgsl:74-93``)
    is a pure function of (position, velocity, initial_color, params); we
    compute it on demand in the consumer (packer / rasterizer). This cuts the
    steady-state step traffic from 64+48 B/particle (reference read+write) to
    24+24 B/particle. Semantics follow the compute-shader backend: switching
    back to ColorMode.ORIGINAL shows initial colors (``compute.wgsl:75-77``;
    the reference CPU backend instead freezes the last computed color,
    ``cpu.rs:106`` — a statefulness artifact we intentionally do not copy).
  * **Padded capacity + dynamic active count.** JAX recompiles per shape, so
    the interactive particle-count UI (``app.rs:442-492``) maps to padded
    capacity buckets with a traced ``n_active`` scalar — mirroring the
    reference's own keep-capacity-on-shrink behavior (``cpu.rs:132-150``).
    Padding particles are zero-initialized and harmlessly stepped; consumers
    slice/mask to ``n_active``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LANE = 128      # row width of the (3, R, LANE) planes
SUBLANE = 8     # capacity row multiple: capacities are multiples of 1024


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def capacity_rows(n: int, row_multiple: int = SUBLANE) -> int:
    """Rows R such that capacity = R*LANE >= n, R aligned for f32 tiles."""
    return max(round_up(cdiv(max(n, 1), LANE), row_multiple), row_multiple)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state. All planes are ``float32[3, R, LANE]``.

    ``pos[c]``/``vel[c]`` hold the x/y/z component planes; ``init_color[c]``
    holds the r/g/b channels of the generation color (alpha is constant 1.0
    in the reference, ``mod.rs:163``, so it is not stored).
    ``n_active`` is a traced int32 scalar: the live particle count.
    """

    pos: jax.Array
    vel: jax.Array
    init_color: jax.Array
    n_active: jax.Array

    # -- static shape helpers ------------------------------------------------
    @property
    def rows(self) -> int:
        return self.pos.shape[1]

    @property
    def capacity(self) -> int:
        return self.pos.shape[1] * self.pos.shape[2]

    # -- construction --------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        positions: np.ndarray,      # float32[n, 3]
        velocities: np.ndarray,     # float32[n, 3]
        init_colors: np.ndarray,    # float32[n, 3] (rgb) or [n, 4]
        capacity: Optional[int] = None,
        row_multiple: int = SUBLANE,
    ) -> "ParticleState":
        n = positions.shape[0]
        rows = (
            capacity_rows(n, row_multiple)
            if capacity is None
            else capacity // LANE
        )
        if rows * LANE < n:
            raise ValueError(f"capacity {rows * LANE} < particle count {n}")

        def to_planes(a: np.ndarray, channels: int) -> jnp.ndarray:
            buf = np.zeros((channels, rows * LANE), dtype=np.float32)
            buf[:, :n] = np.asarray(a, dtype=np.float32)[:, :channels].T
            return jnp.asarray(buf.reshape(channels, rows, LANE))

        return cls(
            pos=to_planes(positions, 3),
            vel=to_planes(velocities, 3),
            init_color=to_planes(init_colors, 3),
            n_active=jnp.asarray(n, dtype=jnp.int32),
        )

    # -- views (host-side, slice to active count) -----------------------------
    def _flat(self, plane: jax.Array) -> np.ndarray:
        n = int(self.n_active)
        return np.asarray(plane.reshape(3, -1)[:, :n]).T  # [n, 3]

    def positions(self) -> np.ndarray:
        return self._flat(self.pos)

    def velocities(self) -> np.ndarray:
        return self._flat(self.vel)

    def init_colors_rgba(self) -> np.ndarray:
        rgb = self._flat(self.init_color)
        return np.concatenate(
            [rgb, np.ones((rgb.shape[0], 1), dtype=np.float32)], axis=1
        )

    # -- device-side views -----------------------------------------------------
    def pos_nx3(self) -> jax.Array:
        """Positions as float32[capacity, 3] (padded; device-side)."""
        return self.pos.reshape(3, -1).T

    def vel_nx3(self) -> jax.Array:
        return self.vel.reshape(3, -1).T

    def active_mask_flat(self) -> jax.Array:
        """bool[capacity]: True for live particles."""
        idx = jnp.arange(self.capacity, dtype=jnp.int32)
        return idx < self.n_active


def _grow_planes_impl(pos, vel, init_color, tail_pos, tail_vel, tail_col,
                      n_old, new_rows: int):
    """Append tail particles at flat index n_old, growing capacity to
    new_rows*LANE. All device-side — no O(N) host roundtrip on resize."""
    def one(plane, tail):
        flat = plane.reshape(3, -1)
        old_n = flat.shape[1]
        if new_rows * LANE > old_n:
            out = jnp.zeros((3, new_rows * LANE), jnp.float32)
            out = jax.lax.dynamic_update_slice(out, flat, (0, 0))
        else:
            out = flat
        out = jax.lax.dynamic_update_slice(out, tail, (0, n_old))
        return out.reshape(3, new_rows, LANE)

    return (one(pos, tail_pos), one(vel, tail_vel), one(init_color, tail_col))


# same-capacity appends update the donated planes in place; capacity growth
# reallocates, where donation is unusable (shape change) and would warn
_grow_planes_inplace = functools.partial(
    jax.jit, static_argnames=("new_rows",),
    donate_argnums=(0, 1, 2))(_grow_planes_impl)
_grow_planes_realloc = functools.partial(
    jax.jit, static_argnames=("new_rows",))(_grow_planes_impl)


def grow_state(state: ParticleState, tail_pos, tail_vel, tail_col,
               new_count: int) -> ParticleState:
    """Grow-append preserving existing state (cpu.rs:136-147 semantics).

    tail_* are host float32[add, 3] arrays for the newly generated
    particles; only the tail crosses to the device.
    """
    add = tail_pos.shape[0]
    new_rows = max(capacity_rows(new_count), state.rows)

    def tail_planes(a):
        buf = np.zeros((3, round_up(max(add, 1), LANE)), dtype=np.float32)
        buf[:, :add] = np.asarray(a, dtype=np.float32)[:, :3].T
        return jnp.asarray(buf)

    # tail is padded to a LANE multiple; it may overwrite padding beyond
    # n_old+add, which is harmless (those slots stay inactive).
    n_old = int(state.n_active)
    tail_width = round_up(max(add, 1), LANE)
    if n_old + tail_width > new_rows * LANE:
        # tail padding would run past capacity: bump capacity one row chunk
        new_rows = capacity_rows(n_old + round_up(max(add, 1), LANE))
    grow = (_grow_planes_inplace if new_rows == state.rows
            else _grow_planes_realloc)
    pos, vel, col = grow(
        state.pos, state.vel, state.init_color,
        tail_planes(tail_pos), tail_planes(tail_vel), tail_planes(tail_col),
        jnp.asarray(n_old, jnp.int32), new_rows)
    return ParticleState(pos=pos, vel=vel, init_color=col,
                         n_active=jnp.asarray(new_count, jnp.int32))


def zeros_state(capacity: int) -> ParticleState:
    rows = capacity_rows(capacity)  # never truncate; keep row alignment
    # three INDEPENDENT buffers: sharing one would let a donating step
    # delete the aliased init_color out from under later color/render use
    return ParticleState(
        pos=jnp.zeros((3, rows, LANE), dtype=jnp.float32),
        vel=jnp.zeros((3, rows, LANE), dtype=jnp.float32),
        init_color=jnp.zeros((3, rows, LANE), dtype=jnp.float32),
        n_active=jnp.asarray(0, dtype=jnp.int32),
    )
