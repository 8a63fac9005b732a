"""Shared per-particle physics and color math.

One implementation of the reference's step math, used by BOTH the jitted
jax.numpy oracle stepper (ops/step_jnp.py — the reference-CPU-method analog)
and the fused Pallas kernel (ops/step_pallas.py — the compute-shader analog).
All functions are shape-polymorphic: they take/return per-component arrays of
any (broadcast-compatible) shape, so the same code runs on full ``(R, 128)``
planes under jit and on one block's register values inside a kernel.

The physics, in the reference's exact operation order
(``/root/reference/src/simulation/cpu.rs:65-113`` and
``/root/reference/src/shaders/compute.wgsl:52-93``):

  1. gravity:   v.y -= g * dt                                (compute.wgsl:53)
  2. attractor: if dragging and |m - p| < 2*r:
                  f = normalize(m - p) * F * (1 - d/(2r))^2 * 2
                  v += f * dt                                (compute.wgsl:56-66)
  3. integrate: p += v * dt        — position BEFORE damping (compute.wgsl:69)
  4. damping:   v *= damping                                 (compute.wgsl:72)

Deviation from the reference (documented): the reference computes
``normalize(dir)`` which is NaN when a particle sits exactly at the mouse
position (``cpu.rs:81``); we clamp the divisor to 1e-12 so the force is 0
there — NaN-free by construction.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Vec3Arrays = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def attractor_step(
    px, py, pz, vx, vy, vz,
    *, dt, gravity, mouse_force, mouse_radius, damping,
    mouse_x, mouse_y, mouse_z, dragging,
) -> Tuple[jnp.ndarray, ...]:
    """One physics step. Scalars may be Python floats or traced 0-d arrays.

    ``dragging`` is a float (0.0/1.0) so the whole step is branchless — the
    reference's per-particle ``if`` (cpu.rs:75-84) becomes a select, so no
    thread of a warp diverges.
    Returns (px, py, pz, vx, vy, vz) after the step.
    """
    one = jnp.float32(1.0)

    # 1. gravity (y only) — compute.wgsl:53
    vy = vy - gravity * dt

    # 2. mouse attractor with quadratic falloff — compute.wgsl:56-66.
    # Formulated around a single rsqrt (the only transcendental in the step):
    # the reference's length() + normalize() (sqrt then divide) cost two;
    # transcendentals are the dearest ops of this kernel, so dist and 1/dist
    # are both derived from rsqrt(dist^2). The cutoff compares squared distances,
    # and the WGSL clamp on norm_dist (compute.wgsl:62) is dropped because
    # `within` already zeroes every lane with norm_dist >= 1 — identical
    # results, fewer ops.
    dx = mouse_x - px
    dy = mouse_y - py
    dz = mouse_z - pz
    dist_sq = dx * dx + dy * dy + dz * dz
    reach = mouse_radius * 2.0
    inv_dist = jax.lax.rsqrt(jnp.maximum(dist_sq, 1e-24))  # safe normalize
    norm_dist = dist_sq * inv_dist * (one / reach)         # = dist / reach
    t = one - norm_dist
    within = (dist_sq < reach * reach).astype(jnp.float32) * dragging
    scale = within * (mouse_force * 2.0 * dt) * t * t * inv_dist
    vx = vx + dx * scale
    vy = vy + dy * scale
    vz = vz + dz * scale

    # 3. integrate position BEFORE damping — compute.wgsl:69
    px = px + vx * dt
    py = py + vy * dt
    pz = pz + vz * dt

    # 4. damping — compute.wgsl:72
    vx = vx * damping
    vy = vy * damping
    vz = vz * damping
    return px, py, pz, vx, vy, vz


def color_rgb(
    px, py, pz, vx, vy, vz, cr, cg, cb,
    *, color_mode, max_dist_for_color,
) -> Vec3Arrays:
    """Per-particle RGB by color mode — compute.wgsl:74-93 (alpha is 1).

    ``color_mode`` is a traced float scalar (0/1/2) selected branchlessly, so
    the interactive mode switch (app.rs:496-507) never recompiles. Mode 0 and
    any unknown mode yield the initial color (wgsl ``case 0``/``default``).
    """
    # mode 1: speed — s = clamp(|v|/5, 0, 1) -> (s, 0.5 - s/2, 1 - s)
    speed = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    s = jnp.clip(speed * jnp.float32(0.2), 0.0, 1.0)

    # mode 2: distance from origin — d = clamp(|p|/max(max_dist, 0.01), 0, 1)
    dist = jnp.sqrt(px * px + py * py + pz * pz)
    d = jnp.clip(dist / jnp.maximum(max_dist_for_color, 0.01), 0.0, 1.0)

    is1 = (jnp.abs(color_mode - 1.0) < 0.5).astype(jnp.float32)
    is2 = (jnp.abs(color_mode - 2.0) < 0.5).astype(jnp.float32)
    is0 = 1.0 - is1 - is2

    r = is0 * cr + is1 * s + is2 * d
    g = is0 * cg + is1 * (0.5 - s * 0.5)
    b = is0 * cb + is1 * (1.0 - s) + is2 * (1.0 - d)
    return r, g, b


def brightness(vx, vy, vz) -> jnp.ndarray:
    """Fragment-shader brightness = min(2*|v|, 1) — particle.wgsl:41-42."""
    speed = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    return jnp.minimum(speed * 2.0, 1.0)


def kick_and_step_planes(pos, vel, acc, param_vec):
    """Shared tail of every interaction solver: accumulate an external
    acceleration into velocity (kick), then run the reference's attractor
    step, on ``(3, R, LANE)`` component planes.

    Keeps the integrator contract (forces -> v, then p += v*dt, then
    v *= damping — compute.wgsl:52-72) in ONE place for the direct-sum,
    ring, and particle-mesh steppers. ``acc`` must broadcast to
    ``pos.shape``; param_vec is the packed SimParams vector.
    """
    from ..core import params as P

    dt = param_vec[P.P_DT]
    vel = vel + acc * dt
    px, py, pz, vx, vy, vz = attractor_step(
        pos[0], pos[1], pos[2], vel[0], vel[1], vel[2],
        dt=dt, gravity=param_vec[P.P_GRAVITY],
        mouse_force=param_vec[P.P_MOUSE_FORCE],
        mouse_radius=param_vec[P.P_MOUSE_RADIUS],
        damping=param_vec[P.P_DAMPING],
        mouse_x=param_vec[P.P_MOUSE_X], mouse_y=param_vec[P.P_MOUSE_Y],
        mouse_z=param_vec[P.P_MOUSE_Z], dragging=param_vec[P.P_DRAGGING],
    )
    return jnp.stack([px, py, pz]), jnp.stack([vx, vy, vz])
