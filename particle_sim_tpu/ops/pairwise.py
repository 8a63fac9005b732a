"""All-pairs O(N^2) interaction — jax.numpy oracle.

Capability extension beyond the reference: the
reference's only force field is the 1-body mouse attractor
(``/root/reference/src/shaders/compute.wgsl:56-66``); this generalizes it to
softened pairwise monopole attraction with unit masses:

    a_i = G * sum_j m_j * (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^(3/2)

The softening eps makes the self-pair contribute exactly zero, so no
self-interaction mask is needed. Inactive (padded) particles ARE masked on
the j side — unlike the independent-particle attractor step, padding would
otherwise exert phantom forces.

The full pairwise step keeps the reference's integrator contract
(gravity/forces accumulate into velocity, then ``p += v*dt``, then
``v *= damping`` — compute.wgsl:52-72); the pairwise acceleration is just one
more force term.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core import params as P
from . import physics


def pairwise_accel(
    pos_flat: jax.Array,   # f32[3, N] component rows
    n_active: jax.Array,   # i32 scalar
    g_const,               # scalar
    softening,             # scalar
    masses=None,           # f32[N] source masses (None = unit)
) -> jax.Array:
    """f32[3, N] accelerations; O(N^2) memory — oracle/small-N path.

    Gravity is an acceleration field: only SOURCE masses enter (the
    receiver's mass cancels), so ``masses`` scales the j side only."""
    n = pos_flat.shape[1]
    diff = pos_flat[:, None, :] - pos_flat[:, :, None]   # [3, i=N, j=N]
    r2 = (diff ** 2).sum(axis=0) + softening * softening
    inv = jax.lax.rsqrt(r2)
    w = g_const * inv * inv * inv                         # [N, N]
    j_idx = jnp.arange(n, dtype=jnp.int32)
    src_w = (j_idx < n_active).astype(jnp.float32)
    if masses is not None:
        src_w = src_w * masses
    w = w * src_w[None, :]
    # HIGHEST: a GPU may otherwise run this f32 contraction in TF32
    return jnp.einsum("ij,cij->ci", w, diff,
                      precision=jax.lax.Precision.HIGHEST)


def pairwise_accel_blocked(
    x_i: jax.Array,        # f32[3, Ni] receivers
    x_j: jax.Array,        # f32[3, Nj] sources
    n_active,              # active count among GLOBAL sources
    g_const,
    softening,
    *,
    j_base=0,              # global index of x_j's first column
    masses=None,           # f32[Nj] source masses (None = unit)
    tile: int = 256,
) -> jax.Array:
    """f32[3, Ni] accelerations — plain XLA, O(tile * Nj) memory.

    The same sum as ``pairwise_accel`` over a ``lax.map`` of receiver
    tiles, with rectangular receivers/sources and the ``j_base`` offset
    of the multi-device ring. It is the no-kernel path of every caller of
    ops/pairwise_pallas.pairwise_accel, and the reference it is checked
    against at sizes where the [3, N, N] oracle cannot exist. Pure
    elementwise math and reductions: no matrix unit, so no TF32."""
    n_i, n_j = x_i.shape[1], x_j.shape[1]
    tile = min(tile, n_i)
    n_t = -(-n_i // tile)
    pad = n_t * tile - n_i
    xi = jnp.pad(x_i, ((0, 0), (0, pad))).reshape(3, n_t, tile)
    j_idx = jnp.arange(n_j, dtype=jnp.int32) + jnp.asarray(j_base, jnp.int32)
    src_w = (jnp.asarray(g_const, jnp.float32)
             * (j_idx < n_active).astype(jnp.float32))
    if masses is not None:
        src_w = src_w * masses
    eps_sq = jnp.asarray(softening, jnp.float32) ** 2

    def one(xt):                                   # (3, tile)
        diff = x_j[:, None, :] - xt[:, :, None]    # (3, tile, Nj)
        inv = jax.lax.rsqrt((diff * diff).sum(axis=0) + eps_sq)
        w = src_w[None, :] * (inv * inv * inv)
        return (w[None] * diff).sum(axis=-1)       # (3, tile)

    out = jax.lax.map(one, jnp.moveaxis(xi, 1, 0))   # (n_t, 3, tile)
    return jnp.moveaxis(out, 0, 1).reshape(3, -1)[:, :n_i]


def step_pairwise(
    pos: jax.Array, vel: jax.Array, param_vec: jax.Array,
    pair_vec: jax.Array,   # f32[2]: (G, softening) — PairwiseParams.pack()
    n_active: jax.Array,
    masses=None,
) -> Tuple[jax.Array, jax.Array]:
    """One step with all-pairs + attractor + gravity on (3, R, LANE) planes."""
    flat = pos.reshape(3, -1)
    acc = pairwise_accel(flat, n_active, pair_vec[0], pair_vec[1],
                         masses=masses)
    return physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                        param_vec)
