"""Multi-device all-pairs forces: ppermute ring over the dp axis.

The communication pattern of ring attention applied to N-body (SURVEY.md §5
"long-context" analog): particles are row-sharded over the mesh; each device
keeps its i-shard fixed and a j-buffer of positions rotates around the
ring of devices. After n_dev hops every i-tile has seen every j-shard
exactly once, so the accumulated force equals the single-device O(N^2) result.

Communication volume per step: each device sends its 12-byte/particle
position shard n_dev-1 times — O(N) bytes against O(N^2/n_dev) compute, so
the ring is compute-bound at any realistic size and XLA overlaps the
ppermute with the next tile's pass. (A bidirectional ring — rotating two
half-buffers in opposite directions, the ring-attention bandwidth
trick — would halve transfer latency, but with compute/comm ratios of
N/n_dev * ~20 FLOPs per 12 bytes it cannot matter below ~billions of
particles; kept unidirectional for simplicity.)

``j_base`` bookkeeping: after k hops a device holds the shard originally
owned by device (my_idx + k) mod n_dev, whose global column offset is
shard_idx * local_n — fed to the pair pass's j-validity mask so global
padding is masked correctly no matter where it currently lives.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core import params as Pm
from ..ops import pairwise, pairwise_pallas, physics
from .mesh import DP_AXIS


def _plane_spec() -> P:
    return P(None, DP_AXIS, None)


def make_ring_pairwise_step(mesh: Mesh, *, interpret: bool = False,
                            use_kernel: bool = False,
                            with_masses: bool = False):
    """Jitted (pos, vel, param_vec, pair_vec, n_active[, masses])
    -> (pos, vel).

    pos/vel are (3, R, LANE) planes row-sharded over dp; n_active is the
    GLOBAL active count (replicated scalar). With ``with_masses``, a
    row-sharded f32[capacity] source-mass array rotates around the ring
    alongside the position shards (sources scale the force; receivers are
    mass-free — gravity is an acceleration field). ``use_kernel`` runs
    each hop's pair pass on ops/pairwise_pallas.py's kernel, else on the
    blocked plain-XLA form.
    """
    n_dev = mesh.devices.size

    def local_step(pos, vel, pv, pairv, n_active, masses=None):
        # pos: local shard (3, R/n_dev, LANE)
        shape = pos.shape
        local_n = shape[1] * shape[2]
        my_idx = jax.lax.axis_index(DP_AXIS)
        flat = pos.reshape(3, -1)             # (3, local_n) fixed i-shard

        def accel_vs(j_buf, j_base, m_buf):
            if use_kernel:
                return pairwise_pallas.pairwise_accel(
                    flat, j_buf, n_active, pairv[0], pairv[1],
                    j_base=j_base, masses=m_buf, interpret=interpret)
            return pairwise.pairwise_accel_blocked(
                flat, j_buf, n_active, pairv[0], pairv[1], j_base=j_base,
                masses=m_buf)

        perm = [(d, (d - 1) % n_dev) for d in range(n_dev)]

        def body(k, carry):
            acc, j_buf, m_buf = carry
            src_shard = (my_idx + k) % n_dev
            j_base = (src_shard * local_n).astype(jnp.int32)
            acc = acc + accel_vs(
                j_buf, j_base, None if masses is None else m_buf)
            j_buf = jax.lax.ppermute(j_buf, DP_AXIS, perm)
            if masses is not None:
                m_buf = jax.lax.ppermute(m_buf, DP_AXIS, perm)
            return acc, j_buf, m_buf

        # literal zeros are unvarying; the loop carry becomes varying after
        # one hop, so mark them device-varying up front (check_vma=True
        # rejects the mismatched carry otherwise)
        acc0 = jax.lax.pcast(jnp.zeros((3, local_n), jnp.float32),
                             DP_AXIS, to="varying")
        m0 = (jax.lax.pcast(jnp.zeros((local_n,), jnp.float32),
                            DP_AXIS, to="varying")
              if masses is None else masses)
        acc, _, _ = jax.lax.fori_loop(0, n_dev, body, (acc0, flat, m0))

        # integrate with the reference's contract (forces -> pos -> damping)
        return physics.kick_and_step_planes(pos, vel, acc.reshape(shape),
                                            pv)

    # check_vma off only for Pallas bodies (kernel vma propagation fails on
    # literal operands in JAX 0.9 — see parallel/dp.py for the citation)
    sharded = shard_map(
        local_step if with_masses
        else (lambda pos, vel, pv, pairv, n:
              local_step(pos, vel, pv, pairv, n)),
        mesh=mesh,
        in_specs=(_plane_spec(), _plane_spec(), P(), P(), P())
        + ((P(DP_AXIS),) if with_masses else ()),
        out_specs=(_plane_spec(), _plane_spec()),
        check_vma=not use_kernel,
    )
    return jax.jit(sharded, donate_argnums=(0, 1))
