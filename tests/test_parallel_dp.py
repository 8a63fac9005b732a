"""Sharded stepping on the virtual 8-device CPU mesh must equal single-device
stepping bit-for-bit (SURVEY.md §4 'multi-device without a cluster')."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import SimParams
from particle_sim_tpu.core.state import ParticleState
from particle_sim_tpu.ops import step_jnp
from particle_sim_tpu.parallel import dp, mesh as mesh_lib

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform"
)


def make_inputs(n=8 * 1024):
    pos, _, col = G.generate(n)
    rng = np.random.default_rng(7)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    state = ParticleState.from_arrays(pos, vel, col)
    pv = jnp.asarray(
        SimParams(gravity=1.2, is_mouse_dragging=True, mouse_force=40.0,
                  mouse_radius=20.0, mouse_position=(1.0, 2.0, 3.0)).pack()
    )
    return state, pv


def test_sharded_step_matches_single_device():
    mesh = mesh_lib.make_mesh()
    n_dev = mesh.devices.size
    state, pv = make_inputs()
    assert state.rows % n_dev == 0

    step_sharded = dp.make_sharded_step(mesh, use_kernel=False)
    pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, state.pos, state.vel)
    gp, gv = step_sharded(pos_sh, vel_sh, pv)

    ep, ev = step_jnp.step(state.pos, state.vel, pv)
    # one-ulp differences allowed: XLA may fuse FMAs differently in the
    # sharded vs unsharded compilation of the same math
    np.testing.assert_allclose(np.asarray(gp), np.asarray(ep), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(ev), rtol=0, atol=1e-5)


@pytest.mark.parametrize("substeps", [1, 3])
def test_sharded_pallas_interpret_matches(substeps):
    mesh = mesh_lib.make_mesh()
    state, pv = make_inputs()
    step_sharded = dp.make_sharded_step(
        mesh, use_kernel=True, substeps=substeps,
        interpret=jax.default_backend() != "gpu"
    )
    pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, state.pos, state.vel)
    gp, gv = step_sharded(pos_sh, vel_sh, pv)
    ep, ev = step_jnp.step_n_jit(jnp.array(state.pos), jnp.array(state.vel),
                                 pv, substeps)
    tol = 1e-6 if substeps == 1 else 1e-5   # few-ulp drift compounds
    np.testing.assert_allclose(np.asarray(gp), np.asarray(ep), rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(ev), rtol=tol, atol=tol)


def test_global_mean_speed():
    mesh = mesh_lib.make_mesh()
    state, _ = make_inputs()
    (vel_sh,) = mesh_lib.shard_state_planes(mesh, state.vel)
    got = float(dp.make_global_mean_speed(mesh)(vel_sh))
    v = np.asarray(state.vel)
    expect = float(np.sqrt((v ** 2).sum(0)).mean())
    assert got == pytest.approx(expect, rel=1e-5)


def test_output_shardings_preserved():
    mesh = mesh_lib.make_mesh()
    state, pv = make_inputs()
    step_sharded = dp.make_sharded_step(mesh, use_kernel=False)
    pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, state.pos, state.vel)
    gp, _ = step_sharded(pos_sh, vel_sh, pv)
    assert gp.sharding == mesh_lib.plane_sharding(mesh)
