"""Fused attractor kernel vs the jnp oracle (the reference's dual-backend
cross-check made explicit — SURVEY.md §4). The kernel compiles only for a
GPU (Pallas on the Triton route); on the CPU it runs in the interpreter."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import SimParams
from particle_sim_tpu.core.state import ParticleState
from particle_sim_tpu.ops import step_jnp, step_pallas
from particle_sim_tpu.utils import parity

INTERPRET = jax.default_backend() != "gpu"


def random_state(n, seed=0):
    pos, _, col = G.generate(n)
    rng = np.random.default_rng(seed)
    vel = rng.normal(size=pos.shape).astype(np.float32) * 3.0
    return ParticleState.from_arrays(pos, vel, col)


PARAMS = [
    SimParams(),
    SimParams(gravity=2.0),
    SimParams(is_mouse_dragging=True, mouse_position=(3.0, -7.0, 20.0),
              mouse_force=80.0, mouse_radius=30.0, gravity=0.7),
]


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("n", [100, 5000])
def test_kernel_matches_oracle(params, n):
    state = random_state(n)
    pv = jnp.asarray(params.pack())
    ep, ev = step_jnp.step(state.pos, state.vel, pv)
    gp, gv = step_pallas.step(state.pos, state.vel, pv, interpret=INTERPRET)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(ep), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(ev), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 1000, step_pallas.BLOCK + 1, 3 * 1024 + 5])
def test_ragged_tiles(n):
    # (3, n) planes whose length is no multiple of the block: the last
    # program's masked loads/stores must leave exactly n particles stepped
    rng = np.random.default_rng(n)
    pos = jnp.asarray(rng.normal(size=(3, n)).astype(np.float32) * 20.0)
    vel = jnp.asarray(rng.normal(size=(3, n)).astype(np.float32))
    pv = jnp.asarray(PARAMS[2].pack())
    ep, ev = step_jnp.step(pos, vel, pv)
    gp, gv = step_pallas.step(pos, vel, pv, interpret=INTERPRET)
    assert gp.shape == (3, n) and gv.shape == (3, n)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(ep), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(ev), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("substeps", [2, 5])
def test_substeps_equal_repeated_single_steps(substeps):
    state = random_state(2000)
    pv = jnp.asarray(PARAMS[2].pack())
    ep, ev = state.pos, state.vel
    for _ in range(substeps):
        ep, ev = step_jnp.step(ep, ev, pv)
    gp, gv = step_pallas.step(state.pos, state.vel, pv, substeps=substeps,
                              interpret=INTERPRET)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(ep), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(ev), rtol=1e-5, atol=1e-5)


def test_step_n_jit_composition():
    state = random_state(1500, seed=3)
    pv = jnp.asarray(SimParams(gravity=1.0).pack())
    ep, ev = step_jnp.step_n_jit(jnp.array(state.pos), jnp.array(state.vel), pv, 6)
    gp, gv = step_pallas.step_n_jit(state.pos, state.vel, pv, 3, substeps=2,
                                    interpret=INTERPRET)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(ep), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(ev), rtol=1e-5, atol=1e-5)


def test_pallas_call_names_its_backend():
    # the kernel states its route and aliases its state planes in place
    jaxpr = jax.make_jaxpr(lambda p, v, q: step_pallas.step(
        p, v, q, substeps=3, interpret=True))(
        jnp.zeros((3, 4096)), jnp.zeros((3, 4096)), jnp.zeros((16,)))
    eqn = next(e for e in jaxpr.jaxpr.eqns
               if e.primitive.name == "pallas_call")
    assert eqn.params["backend"] == "triton"
    assert eqn.params["input_output_aliases"] == ((1, 0), (2, 1))


@pytest.mark.parametrize("substeps", [1, 64])
def test_parity_check_small(substeps):
    # the chip_smoke parity function itself, at a CPU-sized width
    r = parity.attractor(4096, substeps, interpret=True)
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("substeps", [1, 64])
def test_parity_on_card(substeps):
    r = parity.attractor(1_000_000, substeps)
    assert r["ok"], r
