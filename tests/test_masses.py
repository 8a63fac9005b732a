"""Per-particle source masses across the force paths (heavy central
bodies, multi-species scenes — the reference is unit-mass)."""

import jax.numpy as jnp
import numpy as np
import pytest

import particle_sim_tpu as psim
from particle_sim_tpu.core.params import Method, PairwiseParams, PMConfig
from particle_sim_tpu.engine import Engine
from particle_sim_tpu.ops import pairwise, pairwise_pallas, pm, pm_persist


def _two_body(m_heavy=1000.0, dist=20.0):
    x = np.array([[0, 0, 0], [dist, 0, 0]], np.float32)
    masses = np.array([m_heavy, 1.0], np.float32)
    return x, masses


def test_direct_accel_unequal_masses():
    eps, g, dist = 1.0, 2.0, 20.0
    x, masses = _two_body(dist=dist)
    flat = jnp.asarray(x.T)
    a = np.asarray(pairwise.pairwise_accel(
        flat, jnp.asarray(2, jnp.int32), g, eps, masses=jnp.asarray(masses)))
    denom = (dist * dist + eps * eps) ** 1.5
    # light particle pulled by the heavy source, heavy barely moves
    assert a[0, 1] == pytest.approx(-g * 1000.0 * dist / denom, rel=1e-4)
    assert a[0, 0] == pytest.approx(g * 1.0 * dist / denom, rel=1e-4)


def test_pallas_direct_matches_oracle_with_masses():
    rng = np.random.default_rng(0)
    x = (40 * rng.random((1024, 3)) - 20).astype(np.float32)
    masses = (0.1 + 5 * rng.random(1024)).astype(np.float32)
    st = psim.ParticleState.from_arrays(x, np.zeros_like(x),
                                        np.zeros_like(x))
    flat = st.pos.reshape(3, -1)
    m_pad = np.ones((st.capacity,), np.float32)
    m_pad[:1024] = masses
    m_dev = jnp.asarray(m_pad)
    a_oracle = np.asarray(pairwise.pairwise_accel(
        flat, st.n_active, 1.0, 0.5, masses=m_dev))
    a_fast = np.asarray(pairwise_pallas.pairwise_accel(
        flat, flat, st.n_active, 1.0, 0.5, masses=m_dev,
        interpret=True))
    np.testing.assert_allclose(a_fast[:, :1024], a_oracle[:, :1024],
                               rtol=2e-4, atol=1e-5)


@pytest.mark.slow
def test_pm_heavy_center_matches_direct():
    """A heavy central mass + light cloud: PM forces track the direct sum."""
    rng = np.random.default_rng(1)
    n = 2048
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= (10.0 + 30.0 * rng.random(n).astype(np.float32))[:, None]
    x[0] = 0.0  # the heavy center
    masses = np.ones(n, np.float32)
    masses[0] = 500.0
    st = psim.ParticleState.from_arrays(x, np.zeros_like(x),
                                        np.zeros_like(x))
    flat = st.pos.reshape(3, -1)
    m_pad = np.ones((st.capacity,), np.float32)
    m_pad[:n] = masses
    m_dev = jnp.asarray(m_pad)
    cfg = PMConfig(softening=5.0)
    a_pm = np.asarray(pm.pm_accel_ref(flat, st.n_active, 1.0, cfg.softening,
                                      cfg, masses=m_dev))
    ps, a_slot = pm_persist.accel_sorted(
        pm_persist.init_sorted(flat, st.n_active, cfg, masses=m_dev), 1.0,
        cfg, n_active=st.n_active)
    a_fast = np.asarray(pm_persist.unsort(ps, (a_slot,))[0])
    a_direct = np.asarray(pairwise.pairwise_accel(
        flat, st.n_active, 1.0, cfg.softening, masses=m_dev))
    err = np.linalg.norm(a_pm[:, :n] - a_direct[:, :n], axis=0)
    scale = np.linalg.norm(a_direct[:, :n], axis=0).mean()
    assert np.sqrt((err ** 2).mean()) / scale < 0.06
    scale_f = np.abs(a_pm[:, :n]).max()
    np.testing.assert_allclose(a_fast[:, :n], a_pm[:, :n],
                               atol=0.03 * scale_f)


def test_engine_kepler_orbit():
    """Light particle on a circular Kepler orbit around a heavy center:
    radius stays ~constant over a quarter period."""
    g, m_heavy, r = 1.0, 2000.0, 20.0
    eps = 0.1
    v_circ = np.sqrt(g * m_heavy * r * r / (r * r + eps * eps) ** 1.5)
    x = np.array([[0, 0, 0], [r, 0, 0]], np.float32)
    v = np.array([[0, 0, 0], [0, v_circ, 0]], np.float32)
    e = Engine(particle_count=2, method=Method.JNP,
               pairwise=PairwiseParams(g, eps),
               masses=np.array([m_heavy, 1.0], np.float32))
    e.state = psim.ParticleState.from_arrays(x, v, np.zeros_like(x))
    params = psim.SimParams(delta_time=0.002, damping=1.0)
    for _ in range(300):
        e.step(params)
    pos = e.state.positions()
    r_end = np.linalg.norm(pos[1] - pos[0])
    assert r_end == pytest.approx(r, rel=0.05)
    # the heavy center barely moved
    assert np.linalg.norm(pos[0]) < 0.3


def test_engine_masses_resize_and_checkpoint(tmp_path):
    from particle_sim_tpu.io import checkpoint as ckpt

    e = Engine(particle_count=700, method=Method.JNP,
               pairwise=PairwiseParams(1.0, 2.0),
               masses=np.full(700, 2.5, np.float32))
    e.resize(900)  # appended particles get mass 1
    m = np.asarray(e._masses_for_capacity())
    assert m.shape[0] == e.capacity
    assert m[:700].max() == pytest.approx(2.5)
    assert m[700:900].max() == pytest.approx(1.0)
    e.step(psim.SimParams(delta_time=0.01))

    path = str(tmp_path / "m.npz")
    ckpt.save(path, e, step_index=3)
    e2, _ = ckpt.load(path)
    assert e2.masses is not None
    np.testing.assert_allclose(np.asarray(e2.masses[:700]), 2.5)
    e2.step(psim.SimParams(delta_time=0.01))


def test_diagnostics_with_masses():
    from particle_sim_tpu.ops import diagnostics as diag

    x = np.array([[0, 0, 0], [10, 0, 0]], np.float32)
    v = np.array([[1, 0, 0], [0, 2, 0]], np.float32)
    masses = np.array([4.0, 1.0], np.float32)
    st = psim.ParticleState.from_arrays(x, v, np.zeros_like(x))
    m_pad = np.ones((st.capacity,), np.float32)
    m_pad[:2] = masses
    d = diag.measure(st.pos, st.vel, st.n_active, g_const=1.0,
                     softening=1.0, potential=True,
                     masses=jnp.asarray(m_pad))
    assert d.kinetic == pytest.approx(0.5 * (4 * 1 + 1 * 4), rel=1e-5)
    np.testing.assert_allclose(d.momentum, [4.0, 2.0, 0.0], atol=1e-5)
    assert d.potential == pytest.approx(-4.0 / np.sqrt(101.0), rel=1e-5)


def test_checkpoint_after_grow_is_loadable(tmp_path):
    """Regression: save() right after a grow-resize used the stale raw
    masses buffer, producing a truncated (unloadable) checkpoint."""
    from particle_sim_tpu.io import checkpoint as ckpt

    e = Engine(particle_count=700, method=Method.JNP,
               pairwise=PairwiseParams(1.0, 2.0),
               masses=np.full(700, 3.0, np.float32))
    e.resize(5000)  # grow WITHOUT stepping first
    path = str(tmp_path / "grown.npz")
    ckpt.save(path, e, step_index=1)
    e2, _ = ckpt.load(path)
    assert e2.particle_count == 5000
    m = np.asarray(e2.masses[:5000])
    assert m[:700].max() == pytest.approx(3.0)
    assert m[700:].max() == pytest.approx(1.0)


@pytest.mark.slow
def test_mesh_masses_pm_and_ring_match_single_device():
    """Row-sharded masses: psum-grid PM and the mass-rotating ring both
    reproduce the single-device steps."""
    import jax

    from particle_sim_tpu.parallel import mesh as mesh_lib, pm_dp, ring
    from particle_sim_tpu.ops import pairwise as pw

    mesh = mesh_lib.make_mesh()
    n_dev = mesh.devices.size
    n = n_dev * 8 * 128
    rng = np.random.default_rng(3)
    pos = (rng.normal(size=(n, 3)) * 12.0).astype(np.float32)
    masses_np = (0.2 + 3 * rng.random(n)).astype(np.float32)
    st = psim.ParticleState.from_arrays(pos, np.zeros_like(pos),
                                        np.zeros_like(pos),
                                        row_multiple=8 * n_dev)
    m_pad = np.ones((st.capacity,), np.float32)
    m_pad[:n] = masses_np
    m_dev = jnp.asarray(m_pad)
    cfg = PMConfig(softening=5.0)
    pv = jnp.asarray(psim.SimParams(delta_time=0.01).pack())
    pp = jnp.asarray(PairwiseParams(1.0, cfg.softening).pack())
    pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, st.pos, st.vel)

    def active(x):
        return np.asarray(x).reshape(3, -1)[:, :n]

    # PM with masses
    step = pm_dp.make_pm_step(mesh, cfg, with_masses=True)
    p_m, v_m = step(pos_sh, vel_sh, pv, pp, st.n_active, m_dev)
    p_r, v_r = pm.step_pm_ref(jnp.array(st.pos), jnp.array(st.vel), pv, pp,
                              st.n_active, cfg, masses=m_dev)
    np.testing.assert_allclose(active(p_m), active(p_r), atol=1e-2)
    np.testing.assert_allclose(active(v_m), active(v_r), atol=1e-2)

    # ring with rotating masses
    pos_sh2, vel_sh2 = mesh_lib.shard_state_planes(mesh, st.pos, st.vel)
    rstep = ring.make_ring_pairwise_step(mesh, use_kernel=False,
                                         with_masses=True)
    p_g, v_g = rstep(pos_sh2, vel_sh2, pv, pp, st.n_active, m_dev)
    p_o, v_o = pw.step_pairwise(jnp.array(st.pos), jnp.array(st.vel), pv,
                                pp, st.n_active, masses=m_dev)
    np.testing.assert_allclose(active(p_g), active(p_o), atol=1e-3)
    np.testing.assert_allclose(active(v_g), active(v_o), atol=1e-3)


def test_engine_mesh_masses():
    from particle_sim_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh()
    n = mesh.devices.size * 1024
    e = Engine(particle_count=n, method=Method.JNP,
               pairwise=PairwiseParams(1.0, 3.0), mesh=mesh,
               masses=np.full(n, 1.5, np.float32))
    e.step(psim.SimParams(delta_time=0.01))
    assert np.isfinite(e.state.positions()).all()


def test_shrink_then_grow_resets_new_masses():
    """Regression: growth after a shrink must not resurrect the stale
    custom masses of dead particles — grown particles get mass 1."""
    e = Engine(particle_count=100, method=Method.JNP,
               pairwise=PairwiseParams(1.0, 2.0),
               masses=np.full(100, 7.0, np.float32))
    e.resize(50)
    e.resize(80)
    m = np.asarray(e._masses_for_capacity())
    assert m[:50].max() == pytest.approx(7.0)
    np.testing.assert_allclose(m[50:80], 1.0)
