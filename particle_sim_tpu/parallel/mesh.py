"""Device-mesh helpers.

The reference is single-process/single-GPU (SURVEY.md §2 "Parallelism
strategies"); scale-out is defined by this build, not ported: particles are
sharded over a 1-D mesh axis ``"dp"`` via ``jax.sharding``. The attractor
workload needs zero communication (force depends only on own state + the
broadcast params), so stepping scales linearly over the devices; the
all-pairs extension adds a ppermute ring (parallel/ring.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DP_AXIS,))


def plane_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of a (3, R, LANE) component plane: rows split over dp."""
    return NamedSharding(mesh, P(None, DP_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state_planes(mesh: Mesh, *planes: jax.Array):
    """Place component planes row-sharded over the mesh."""
    sh = plane_sharding(mesh)
    return tuple(jax.device_put(p, sh) for p in planes)
