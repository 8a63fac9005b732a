"""All-pairs force: oracle vs direct sum, Triton kernel vs oracle, ring vs
single-device."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import PairwiseParams, SimParams
from particle_sim_tpu.core.state import ParticleState
from particle_sim_tpu.ops import pairwise, pairwise_pallas
from particle_sim_tpu.parallel import mesh as mesh_lib, ring
from particle_sim_tpu.utils import parity

INTERPRET = jax.default_backend() != "gpu"
GC, EPS = 2.5, 0.5


def direct_numpy_accel(pos_nx3, n_active):
    """Independent O(N^2) loop transcription of the documented formula."""
    n = pos_nx3.shape[0]
    acc = np.zeros((n, 3), dtype=np.float64)
    p = pos_nx3.astype(np.float64)
    for i in range(n):
        d = p[:n_active] - p[i]
        r2 = (d ** 2).sum(1) + EPS * EPS
        acc[i] = (GC * d / r2[:, None] ** 1.5).sum(0)
    return acc


def make_state(n, seed=0):
    pos, _, col = G.generate(n, G.SphereGeneration.FILLED)
    return ParticleState.from_arrays(pos, np.zeros_like(pos), col)


class TestOracle:
    def test_matches_direct_sum(self):
        state = make_state(300)
        n = int(state.n_active)
        flat = state.pos.reshape(3, -1)
        acc = pairwise.pairwise_accel(flat, state.n_active, GC, EPS)
        got = np.asarray(acc)[:, :n].T
        expect = direct_numpy_accel(state.positions(), n)
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)

    def test_momentum_conserved(self):
        # equal masses: sum of all internal forces is zero
        state = make_state(500)
        n = int(state.n_active)
        flat = state.pos.reshape(3, -1)
        acc = np.asarray(pairwise.pairwise_accel(flat, state.n_active, GC, EPS))
        total = np.abs(acc[:, :n].sum(axis=1))
        scale = np.abs(acc[:, :n]).sum()
        assert (total / max(scale, 1e-9) < 1e-5).all()

    def test_padding_masked(self):
        # forces must be identical whether capacity padding is 0 or garbage
        state = make_state(200)
        flat = np.asarray(state.pos.reshape(3, -1))
        n = int(state.n_active)
        poisoned = flat.copy()
        poisoned[:, n:] = 1e3
        a0 = np.asarray(pairwise.pairwise_accel(jnp.asarray(flat),
                                                state.n_active, GC, EPS))
        a1 = np.asarray(pairwise.pairwise_accel(jnp.asarray(poisoned),
                                                state.n_active, GC, EPS))
        np.testing.assert_array_equal(a0[:, :n], a1[:, :n])


class TestPallasKernel:
    """ops/pairwise_pallas.py (Triton route; the interpreter on a CPU)."""

    @pytest.mark.parametrize("n", [1024, 4096])
    def test_matches_oracle(self, n):
        state = make_state(n)
        flat = state.pos.reshape(3, -1)
        expect = pairwise.pairwise_accel(flat, state.n_active, GC, EPS)
        got = pairwise_pallas.pairwise_accel(
            flat, flat, state.n_active, GC, EPS, interpret=INTERPRET)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                                   rtol=2e-4, atol=1e-5)

    @pytest.mark.parametrize("n_i,n_j,n_active", [
        (1500, 1500, 1500),     # no multiple of either block
        (2048, 2048, 1500),     # padded capacity, masked tail
        (33, 129, 100),         # one partial block each way
        (1, 300, 257),          # a single receiver
    ])
    def test_ragged_and_masked(self, n_i, n_j, n_active):
        rng = np.random.default_rng(n_i + n_j)
        xi = jnp.asarray(rng.normal(size=(3, n_i)).astype(np.float32) * 5)
        xj = jnp.asarray(rng.normal(size=(3, n_j)).astype(np.float32) * 5)
        got = pairwise_pallas.pairwise_accel(xi, xj, n_active, GC, EPS,
                                             interpret=INTERPRET)
        expect = pairwise.pairwise_accel_blocked(xi, xj, n_active, GC, EPS,
                                                 tile=64)
        assert got.shape == (3, n_i)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                                   rtol=2e-4, atol=1e-5)

    def test_j_base_offset(self):
        # computing against the second half of sources with j_base must equal
        # the oracle restricted to those sources
        state = make_state(2048)
        flat = state.pos.reshape(3, -1)
        n = flat.shape[1]
        half = n // 2
        got = pairwise_pallas.pairwise_accel(
            flat, flat[:, half:], state.n_active, GC, EPS,
            j_base=half, interpret=INTERPRET)
        # oracle: full minus first half (both j_base-masked by n_active)
        full = pairwise.pairwise_accel(flat, state.n_active, GC, EPS)
        first = pairwise_pallas.pairwise_accel(
            flat, flat[:, :half], state.n_active, GC, EPS,
            j_base=0, interpret=INTERPRET)
        np.testing.assert_allclose(
            np.asarray(got) + np.asarray(first), np.asarray(full),
            rtol=2e-4, atol=1e-4)

    def test_source_masses(self):
        # masses scale sources only; a mass-2 source equals two coincident
        # unit sources
        state = make_state(1000)
        flat = state.pos.reshape(3, -1)
        m = np.ones(flat.shape[1], np.float32)
        m[:300] = 2.0
        got = pairwise_pallas.pairwise_accel(
            flat, flat, state.n_active, GC, EPS, masses=jnp.asarray(m),
            interpret=INTERPRET)
        expect = pairwise.pairwise_accel(flat, state.n_active, GC, EPS,
                                         masses=jnp.asarray(m))
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                                   rtol=2e-4, atol=1e-5)

    def test_step_pairwise_matches_oracle_step(self):
        state = make_state(1024)
        pv = jnp.asarray(SimParams(gravity=0.3, is_mouse_dragging=True,
                                   mouse_position=(0, 0, 10),
                                   mouse_force=20.0).pack())
        pp = jnp.asarray(PairwiseParams(GC, EPS).pack())
        ep, ev = pairwise.step_pairwise(state.pos, state.vel, pv, pp,
                                        state.n_active)
        gp, gv = pairwise_pallas.step_pairwise(state.pos, state.vel, pv, pp,
                                               state.n_active,
                                               interpret=INTERPRET)
        np.testing.assert_allclose(np.asarray(gp), np.asarray(ep),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gv), np.asarray(ev),
                                   rtol=1e-4, atol=1e-5)

    def test_parity_check_small(self):
        # the chip_smoke parity function itself, at a CPU-sized width
        r = parity.pairwise(2048, interpret=True)
        assert r["ok"], r

    @pytest.mark.gpu
    def test_parity_on_card(self):
        r = parity.pairwise(65_536)
        assert r["ok"], r


class TestBlockedReference:
    @pytest.mark.parametrize("tile", [64, 100, 4096])
    def test_blocked_matches_oracle(self, tile):
        # the no-kernel all-pairs path: any tile, dividing or not
        state = make_state(1500)
        flat = state.pos.reshape(3, -1)
        expect = pairwise.pairwise_accel(flat, state.n_active, GC, EPS)
        got = pairwise.pairwise_accel_blocked(flat, flat, state.n_active,
                                              GC, EPS, tile=tile)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device")
class TestRing:
    def test_ring_matches_single_device(self):
        mesh = mesh_lib.make_mesh()
        state = make_state(8 * 1024)
        pv = jnp.asarray(SimParams(gravity=0.2).pack())
        pp = jnp.asarray(PairwiseParams(GC, EPS).pack())

        ep, ev = pairwise.step_pairwise(state.pos, state.vel, pv, pp,
                                        state.n_active)

        step = ring.make_ring_pairwise_step(mesh, interpret=INTERPRET,
                                            use_kernel=True)
        pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, state.pos, state.vel)
        gp, gv = step(pos_sh, vel_sh, pv, pp, state.n_active)
        np.testing.assert_allclose(np.asarray(gp), np.asarray(ep),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(gv), np.asarray(ev),
                                   rtol=1e-4, atol=1e-4)

    def test_ring_masks_global_padding(self):
        # n_active smaller than one shard: most shards are pure padding
        mesh = mesh_lib.make_mesh()
        state = make_state(900)  # capacity 1024 -> one row per device
        assert state.capacity == 1024
        pv = jnp.asarray(SimParams().pack())
        pp = jnp.asarray(PairwiseParams(GC, EPS).pack())
        ep, ev = pairwise.step_pairwise(state.pos, state.vel, pv, pp,
                                        state.n_active)
        step = ring.make_ring_pairwise_step(mesh, interpret=INTERPRET)
        pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, state.pos, state.vel)
        gp, gv = step(pos_sh, vel_sh, pv, pp, state.n_active)
        n = int(state.n_active)
        got = np.asarray(gp).reshape(3, -1)[:, :n]
        exp = np.asarray(ep).reshape(3, -1)[:, :n]
        np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4)
