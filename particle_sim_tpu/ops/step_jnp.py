"""Reference stepper: pure jax.numpy, jitted by XLA.

The analog of the reference's CPU (rayon) backend
(``/root/reference/src/simulation/cpu.rs:39-121``): same math, vectorized
over SoA planes instead of ``par_iter_mut`` over AoS structs. Serves as the
parity oracle for the fused kernel (ops/step_pallas.py) — mirroring the
reference's own implicit CPU-vs-compute-shader A/B oracle — and is the
interactive frame's stepper on every backend (engine.select_paths).

All parameters arrive as one traced float32 vector (see core/params.py), so
live parameter edits never recompile. State planes are donated by callers
(engine layer) for in-place double-buffering in device memory — the
equivalent of the reference's persistent STORAGE buffer
(``compute.rs:28-34``).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core import params as P
from . import physics


def _unpack(pv: jax.Array):
    return dict(
        dt=pv[P.P_DT], gravity=pv[P.P_GRAVITY],
        mouse_force=pv[P.P_MOUSE_FORCE], mouse_radius=pv[P.P_MOUSE_RADIUS],
        damping=pv[P.P_DAMPING],
        mouse_x=pv[P.P_MOUSE_X], mouse_y=pv[P.P_MOUSE_Y], mouse_z=pv[P.P_MOUSE_Z],
        dragging=pv[P.P_DRAGGING],
    )


def step(
    pos: jax.Array, vel: jax.Array, param_vec: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """One attractor step on (3, ...) component planes. Traceable."""
    px, py, pz, vx, vy, vz = physics.attractor_step(
        pos[0], pos[1], pos[2], vel[0], vel[1], vel[2], **_unpack(param_vec)
    )
    return jnp.stack([px, py, pz]), jnp.stack([vx, vy, vz])


@partial(jax.jit, donate_argnums=(0, 1))
def step_jit(pos, vel, param_vec):
    return step(pos, vel, param_vec)


@partial(jax.jit, donate_argnums=(0, 1), static_argnums=(3,))
def step_n_jit(pos, vel, param_vec, n_steps: int):
    """``n_steps`` fused steps with constant params (headless batch mode)."""
    def body(_, carry):
        return step(carry[0], carry[1], param_vec)
    return jax.lax.fori_loop(0, n_steps, body, (pos, vel))


def colors(
    pos: jax.Array, vel: jax.Array, init_color: jax.Array, param_vec: jax.Array
) -> jax.Array:
    """RGB planes (3, ...) for the current state — compute.wgsl:74-93."""
    r, g, b = physics.color_rgb(
        pos[0], pos[1], pos[2], vel[0], vel[1], vel[2],
        init_color[0], init_color[1], init_color[2],
        color_mode=param_vec[P.P_COLOR_MODE],
        max_dist_for_color=param_vec[P.P_MAX_DIST],
    )
    return jnp.stack([r, g, b])


colors_jit = jax.jit(colors)
