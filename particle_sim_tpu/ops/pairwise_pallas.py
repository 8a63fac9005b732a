"""All-pairs softened gravity — a Pallas kernel on the Triton route.

Nothing in the reference to port (its physics is per-particle independent);
this is the classic GPU N-body form (GPU Gems 3, ch. 31; PAPERS.md):

  * one program owns a block of ``BLOCK_I`` receivers; their positions and
    the acceleration accumulators stay in registers for the whole sweep;
  * a loop inside the program walks the sources in ``BLOCK_J`` tiles,
    loaded with masks, and forms the (BLOCK_I, BLOCK_J) pair tile;
  * the accumulators are (BLOCK_I, BLOCK_J) tiles summed elementwise, and
    reduced over j once after the loop — a per-tile reduction costs a
    cross-thread shuffle every step (measured 5x slower on an H100);
  * one ``rsqrt`` per pair; everything else is mul/add, all in f32.

Validity, the gravitational constant and the source masses fold into one
per-source weight ``G * m_j * [j_base + j < n_active]`` computed outside the
kernel (O(N) work), so the O(N^2) loop carries no compare. ``j_base``
offsets the global source index for the multi-device ring
(parallel/ring.py), where the source buffer is a rotating shard. The
softened self-pair contributes zero force (numerator is 0), so i == j needs
no mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Block shape from a sweep on an H100 (PERF.md): 32x128 with 4 warps was
# fastest at 65,536 particles; 64x64 and 128x32 within 6%.
BLOCK_I = 32       # receivers per program
BLOCK_J = 128      # sources per loop step
NUM_WARPS = 4


def _kernel(eps_ref, xi_ref, xj_ref, gv_ref, out_ref, *, n_i, n_j):
    i0 = pl.program_id(0) * BLOCK_I
    rows = pl.ds(i0, BLOCK_I)
    mask_i = i0 + jnp.arange(BLOCK_I, dtype=jnp.int32) < n_i
    xi, yi, zi = (plgpu.load(xi_ref.at[c, rows], mask=mask_i, other=0.0)
                  for c in range(3))
    eps_sq = eps_ref[0]

    def body(t, acc):
        j0 = t * BLOCK_J
        cols = pl.ds(j0, BLOCK_J)
        mask_j = j0 + jnp.arange(BLOCK_J, dtype=jnp.int32) < n_j
        xj, yj, zj = (plgpu.load(xj_ref.at[c, cols], mask=mask_j, other=0.0)
                      for c in range(3))
        gv = plgpu.load(gv_ref.at[cols], mask=mask_j, other=0.0)
        dx = xj[None, :] - xi[:, None]
        dy = yj[None, :] - yi[:, None]
        dz = zj[None, :] - zi[:, None]
        inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz + eps_sq)
        w = gv[None, :] * (inv * inv * inv)
        return acc[0] + w * dx, acc[1] + w * dy, acc[2] + w * dz

    zero = jnp.zeros((BLOCK_I, BLOCK_J), jnp.float32)
    acc = jax.lax.fori_loop(0, pl.cdiv(n_j, BLOCK_J), body,
                            (zero, zero, zero))
    for c in range(3):
        plgpu.store(out_ref.at[c, rows], jnp.sum(acc[c], axis=1),
                    mask=mask_i)


@functools.lru_cache(maxsize=None)
def _build(n_i: int, n_j: int, interpret: bool):
    return pl.pallas_call(
        functools.partial(_kernel, n_i=n_i, n_j=n_j),
        backend="triton",
        grid=(pl.cdiv(n_i, BLOCK_I),),
        out_shape=jax.ShapeDtypeStruct((3, n_i), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="pairwise_accel",
        cost_estimate=pl.CostEstimate(
            flops=20 * n_i * n_j,
            bytes_accessed=4 * (3 * n_i + 4 * n_j * pl.cdiv(n_i, BLOCK_I)
                                + 3 * n_i),
            transcendentals=n_i * n_j,
        ),
    )


def source_weights(n_j: int, n_active, g_const, *, j_base=0, masses=None):
    """f32[n_j] per-source weight G * m_j * [j_base + j < n_active]."""
    j_idx = jnp.arange(n_j, dtype=jnp.int32) + jnp.asarray(j_base, jnp.int32)
    g = (jnp.asarray(g_const, jnp.float32)
         * (j_idx < n_active).astype(jnp.float32))
    return g if masses is None else g * masses


def pairwise_accel(
    x_i: jax.Array,        # f32[3, Ni] — receiver positions
    x_j: jax.Array,        # f32[3, Nj] — source positions (may be a ring buf)
    n_active,              # active count among GLOBAL sources
    g_const,
    softening,
    *,
    j_base=0,              # global index of x_j's first column
    masses=None,           # f32[Nj] source masses (None = unit)
    interpret: bool = False,
) -> jax.Array:
    """f32[3, Ni] accelerations from all sources. Traceable.

    ``masses`` folds into the per-source weight — the O(N^2) kernel is
    mass-free (gravity is an acceleration field; receiver mass cancels)."""
    n_i = x_i.shape[1]
    n_j = x_j.shape[1]
    gv = source_weights(n_j, n_active, g_const, j_base=j_base, masses=masses)
    eps_sq = (jnp.asarray(softening, jnp.float32) ** 2).reshape(1)
    call = _build(n_i, n_j, interpret)
    return call(eps_sq, x_i.astype(jnp.float32), x_j.astype(jnp.float32), gv)


def step_pairwise(
    pos: jax.Array, vel: jax.Array, param_vec: jax.Array,
    pair_vec: jax.Array, n_active, *, masses=None, interpret: bool = False,
):
    """Kernel analog of ops.pairwise.step_pairwise on (3, R, LANE) planes."""
    from . import physics

    flat = pos.reshape(3, -1)
    acc = pairwise_accel(flat, flat, n_active, pair_vec[0], pair_vec[1],
                         masses=masses, interpret=interpret)
    return physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                        param_vec)
