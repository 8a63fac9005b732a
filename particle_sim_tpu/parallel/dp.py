"""Data-parallel (particle-sharded) stepping via shard_map.

The multi-device form of the reference's only scaling mechanism — more GPU
threads (``compute.rs:141-143``): state planes are row-sharded over the
``dp`` mesh axis and every device steps its shard with the same stepper.
The attractor force is per-particle independent, so the step body contains no
collectives; ``global_mean_speed`` shows the psum-based diagnostics pattern
(the analog of the reference's stats UI readouts, ``app.rs:325-330``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import step_jnp, step_pallas
from .mesh import DP_AXIS


def _plane_spec() -> P:
    return P(None, DP_AXIS, None)


def make_sharded_step(mesh: Mesh, *, use_kernel: bool, substeps: int = 1,
                      interpret: bool = False):
    """Returns jitted (pos, vel, param_vec) -> (pos, vel), row-sharded.

    Inside shard_map each device sees its local (3, R/n_dev, LANE) shard and
    runs the single-device stepper on it — zero communication.
    ``use_kernel`` runs the fused kernel (ops/step_pallas.py).
    """

    def local_step(pos, vel, pv):
        if use_kernel:
            return step_pallas.step(pos, vel, pv, substeps=substeps,
                                    interpret=interpret)
        if substeps == 1:
            return step_jnp.step(pos, vel, pv)
        def body(_, c):
            return step_jnp.step(c[0], c[1], pv)
        return jax.lax.fori_loop(0, substeps, body, (pos, vel))

    # check_vma must stay off for Pallas bodies: pallas_call kernels fail
    # vma propagation on literal operands ("Primitive mul requires varying
    # manual axes to match"; JAX 0.9 suggests check_vma=False as the
    # workaround). The XLA path keeps the full varying-manual-axes check.
    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(_plane_spec(), _plane_spec(), P()),
        out_specs=(_plane_spec(), _plane_spec()),
        check_vma=not use_kernel,
    )
    return jax.jit(sharded, donate_argnums=(0, 1))


def make_global_mean_speed(mesh: Mesh):
    """Jitted diagnostics: mean |v| over ALL shards (psum over dp)."""

    def local(vel):
        speed = jnp.sqrt(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2)
        s = jax.lax.psum(jnp.sum(speed), DP_AXIS)
        n = jax.lax.psum(jnp.float32(speed.size), DP_AXIS)
        return s / n

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(_plane_spec(),), out_specs=P(),
    ))
