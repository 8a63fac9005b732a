"""Two-level PM: sub-mesh force accuracy, composition semantics, parity.

Oracle chain (SURVEY.md §4): the direct softened sum at the FINE
softening is the ground truth inside the refinement window; outside,
the two-level result must degrade exactly to the coarse field (plus the
constant momentum-clean shift)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_sim_tpu.core.params import PMConfig
from particle_sim_tpu.ops import pairwise, pm, pm2

CFG = PMConfig(grid=128, box_min=(-64,) * 3, box_size=128.0, softening=3.0)
CFG2 = pm2.PM2Config(window_min=(-16.0,) * 3, window_size=32.0,
                     softening=0.75)
EPS_FINE = 0.75


def _scene(seed=0):
    rng = np.random.default_rng(seed)

    def cloud(n, radius, offset=(0, 0, 0)):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
        return (x * r[:, None] + np.asarray(offset, np.float32)).astype(
            np.float32)

    pos_np = np.concatenate([cloud(3000, 5.0), cloud(1000, 45.0)])
    n = pos_np.shape[0]
    cap = -(-n // 512) * 512
    pos = jnp.asarray(np.concatenate(
        [pos_np, np.zeros((cap - n, 3), np.float32)]).T)
    return pos_np, pos, jnp.asarray(n, jnp.int32)


def _inner_mask(pos_np, margin=12.0):
    return np.all((pos_np >= -16 + margin) & (pos_np < 16 - margin), axis=1)


@pytest.mark.slow
def test_subgrid_accuracy_beats_single_level():
    """Inside the window, two-level PM reproduces the direct sum at the
    FINE softening (eps = 0.75 = 3 fine cells) — which no single-level
    128^3 mesh over the full box can: a mesh-resolved softening (3 h1)
    over-smooths by ~50% rms in the clump, and forcing eps = 0.75 on
    h1 = 1 under-resolves to ~5% rms. Measured two-level: ~1.9%."""
    pos_np, pos, n_act = _scene()
    n = int(n_act)
    a2 = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2))[:, :n]
    a_dir = np.asarray(pairwise.pairwise_accel(
        pos, n_act, 1.0, EPS_FINE))[:, :n]
    a_coarse = np.asarray(pm.pm_accel_ref(
        pos, n_act, 1.0, CFG.softening, CFG))[:, :n]

    inner = _inner_mask(pos_np)
    assert inner.sum() > 2000
    mag = np.linalg.norm(a_dir[:, inner], axis=0).mean()

    def rms(a):
        d = np.linalg.norm(a[:, inner] - a_dir[:, inner], axis=0)
        return np.sqrt((d ** 2).mean()) / mag

    assert rms(a2) < 0.03, f"two-level rms {rms(a2):.4f}"
    assert rms(a_coarse) > 0.3          # the problem is real
    assert rms(a2) < rms(a_coarse) / 10  # and two-level solves it


def test_outside_window_is_coarse_plus_constant():
    """Particles outside the window get exactly the coarse field; the
    only difference is the spatially-CONSTANT momentum-clean shift from
    the fine level's inner/shell asymmetry."""
    pos_np, pos, n_act = _scene(1)
    n = int(n_act)
    a2 = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2))[:, :n]
    a_coarse = np.asarray(pm.pm_accel_ref(
        pos, n_act, 1.0, CFG.softening, CFG))[:, :n]
    out = ~np.all((pos_np >= -16) & (pos_np < 16), axis=1)
    assert out.sum() > 500
    diff = a2[:, out] - a_coarse[:, out]
    scale = np.abs(a_coarse).max()
    assert diff.std(axis=1).max() < 1e-4 * scale     # constant per axis
    assert np.abs(diff).max() < 0.05 * scale         # and small


def test_momentum_conserved():
    pos_np, pos, n_act = _scene(3)
    n = int(n_act)
    a2 = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2))[:, :n]
    typical = np.abs(a2).max()
    assert np.abs(a2.sum(axis=1)).max() < 1e-3 * typical * n ** 0.5


def test_step_contract_and_masses():
    """step_pm2 integrates; doubling a source's mass doubles its fine
    pull on a close neighbor (the correction respects masses)."""
    import particle_sim_tpu as psim

    pos_np, pos, n_act = _scene(4)
    n = int(n_act)
    cap = pos.shape[1]
    pv = jnp.asarray(psim.SimParams(delta_time=0.016, gravity=0.0).pack())
    pp = jnp.asarray(psim.PairwiseParams(1.0, CFG.softening).pack())
    shape = (3, cap // 128, 128)
    p, v = pm2.step_pm2(pos.reshape(shape), jnp.zeros(shape), pv, pp,
                        n_act, CFG, CFG2)
    assert np.isfinite(np.asarray(p)).all()

    # heavy source + neighbor both deep inside the margin-shrunk inner
    # region ([-4, 4)^3 here), where the fine correction applies
    i0 = int(np.argmin(np.linalg.norm(pos_np, axis=1)))
    d = np.linalg.norm(pos_np - pos_np[i0], axis=1)
    d[i0] = np.inf
    j = int(np.argmin(d))
    assert np.abs(pos_np[[i0, j]]).max() < 4.0

    masses = jnp.ones((cap,), jnp.float32)
    a1 = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2,
                                      masses=masses))
    a2_ = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2,
                                       masses=masses.at[i0].set(50.0)))
    # the neighbor's acceleration changes by ~49x the FINE softened
    # kernel of the heavy source (the extra mass resolves at eps_fine
    # inside the window, not the coarse smoothing). CIC at one-cell
    # separations smooths the kernel — allow a generous band.
    delta = np.linalg.norm(a2_[:, j] - a1[:, j])
    r = pos_np[i0] - pos_np[j]
    expect = 49.0 * np.linalg.norm(
        r / (np.dot(r, r) + EPS_FINE ** 2) ** 1.5)
    assert 0.4 * expect < delta < 2.0 * expect, (delta, expect)


@pytest.mark.slow
def test_kernels_as_arguments_bit_exact():
    """Passing fine_kernels() device buffers as the ``kernels`` jit
    argument (pm.diff_kernels_device: no kernel constants embedded in
    the program) reproduces the embedded-constant path exactly: the
    (real, imag) f32 split of a complex64 kernel recombines losslessly."""
    pos_np, pos, n_act = _scene(7)
    ker = pm2.fine_kernels(CFG, CFG2)
    assert all(r.dtype == jnp.float32 for r, _ in ker) and len(ker) == 3
    a_const = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2))
    a_arg = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2,
                                         kernels=ker))
    np.testing.assert_array_equal(a_const, a_arg)
    # and through the jitted step entry the engine uses
    cap = pos.shape[1]
    import particle_sim_tpu as psim
    pv = jnp.asarray(psim.SimParams(delta_time=0.016, gravity=0.0).pack())
    pp = jnp.asarray(psim.PairwiseParams(1.0, CFG.softening).pack())
    shape = (3, cap // 128, 128)
    p1, v1 = pm2.step_pm2_jit(pos.reshape(shape), jnp.zeros(shape), pv, pp,
                              n_act, CFG, CFG2)
    p2, v2 = pm2.step_pm2_jit(pos.reshape(shape), jnp.zeros(shape), pv, pp,
                              n_act, CFG, CFG2, kernels=ker)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_rejects_auto_box():
    pos_np, pos, n_act = _scene(5)
    with pytest.raises(ValueError, match="static"):
        pm2.pm2_accel_ref(pos, n_act, 1.0,
                          PMConfig(softening=3.0, auto_box=True), CFG2)


def test_auto_window_tracks_centroid():
    """window_min=None: the window follows the live mass centroid, so an
    off-center clump still gets fine-softened forces."""
    rng = np.random.default_rng(6)

    def cloud(n, radius, offset=(0, 0, 0)):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
        return (x * r[:, None] + np.asarray(offset, np.float32)).astype(
            np.float32)

    off = (5.0, 4.0, -3.0)
    pos_np = np.concatenate([cloud(3000, 5.0, off), cloud(1000, 45.0)])
    n = pos_np.shape[0]
    cap = -(-n // 512) * 512
    pos = jnp.asarray(np.concatenate(
        [pos_np, np.zeros((cap - n, 3), np.float32)]).T)
    n_act = jnp.asarray(n, jnp.int32)
    cfg2 = pm2.PM2Config(window_min=None, window_size=32.0, softening=0.75)

    wmin = np.asarray(pm2.window_min(pos, n_act, cfg2))
    centroid = pos_np.mean(axis=0)
    np.testing.assert_allclose(wmin, centroid - 16.0, atol=1e-3)

    a2 = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, cfg2))[:, :n]
    a_dir = np.asarray(pairwise.pairwise_accel(
        pos, n_act, 1.0, EPS_FINE))[:, :n]
    near = np.abs(pos_np - centroid).max(axis=1) < 3.0
    assert near.sum() > 300
    mag = np.linalg.norm(a_dir[:, near], axis=0).mean()
    rms = np.sqrt((np.linalg.norm(a2[:, near] - a_dir[:, near],
                                  axis=0) ** 2).mean()) / mag
    assert rms < 0.04, f"auto-window rms {rms:.4f}"


@pytest.mark.slow
def test_engine_integration():
    """Engine(pm2=...) steps the two-level solver; bad configs rejected."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine

    e = Engine(particle_count=1500, method=Method.PALLAS, interpret=True,
               pm=CFG, pm2=CFG2)
    e.step(psim.SimParams(delta_time=0.016, gravity=0.0))
    assert bool(jnp.isfinite(e.state.pos).all())

    # pm2 config survives a checkpoint roundtrip
    import tempfile, os
    from particle_sim_tpu.io import checkpoint as ckpt
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "c.npz")
        ckpt.save(path, e, step_index=3)
        e2, step = ckpt.load(path, method=Method.JNP)
        assert step == 3 and e2.pm2 == CFG2

    with pytest.raises(ValueError, match="pm2 requires"):
        Engine(particle_count=512, method=Method.JNP, interpret=True,
               pm2=CFG2)


@pytest.mark.slow
def test_persist_fine_segmented_steady_state():
    """The first two-level call migrates a fresh coarse-only state into
    the SEGMENTED order (exactly one repair); the second call is the
    sort-free steady state (zero additional repairs), its fine span
    totals fit the shared budgets, and both calls match the
    identity-order reference."""
    from particle_sim_tpu.ops import pm_persist

    pos_np, pos, n_act = _scene(21)
    n = int(n_act)
    ker = pm2.fine_kernels(CFG, CFG2)
    a_id = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2,
                                    kernels=ker))[:, :n]
    st = pm_persist.init_sorted(pos, n_act, CFG)
    st1, a1 = pm_persist.accel_sorted(st, jnp.float32(1.0), CFG,
                                      n_active=n_act,
                                      cfg2=CFG2, kernels=ker)
    assert int(st1.resorts) == 1          # migration into segments
    assert 0 < int(st1.fine_b) < st1.pos.shape[1]
    st2, a_slot = pm_persist.accel_sorted(st1, jnp.float32(1.0), CFG,
                                          n_active=n_act,
                                          cfg2=CFG2, kernels=ker)
    assert int(st2.resorts) == 1          # steady: no additional repair
    # the fine span tables fit the shared budgets (sort-free leg taken)
    cap = st2.pos.shape[1]
    chunk = pm_persist.pick_chunk(cap)
    cd, cg = pm_persist.budgets(cap // chunk)
    wmin = pm2.window_min(st2.pos, None, CFG2, None,
                          live=st2.ids < n_act)
    _, key2 = pm_persist._fine_inputs(
        st2.pos, st2.ids < n_act, wmin, CFG, CFG2)
    key2 = jnp.where(jnp.arange(cap) >= st2.fine_b, key2,
                     pm_persist._GEOM128.sentinel)
    dep2, gat2 = pm_persist._pair_totals(key2, chunk)
    assert int(dep2) <= cd
    assert int(gat2) <= cg
    for sti, ai in ((st1, a1), (st2, a_slot)):
        ids = np.asarray(sti.ids)
        a_back = np.zeros_like(np.asarray(ai))
        a_back[:, ids] = np.asarray(ai)
        scale = np.abs(a_id).max()
        assert np.abs(a_back[:, :n] - a_id).max() < 5e-3 * scale


@pytest.mark.slow
def test_persist_composite_edge_churn_exact():
    """Window-edge churn BETWEEN repairs stays exact with the FROZEN
    segmented membership: leavers stop depositing (zero source mask) and
    park-band crossers were already in segment B at the last repair — a
    drift pushing bands across the window faces keeps parity with the
    identity-order reference at zero additional repairs."""
    from particle_sim_tpu.ops import pm_persist

    pos_np, pos, n_act = _scene(22)
    n = int(n_act)
    # plant bands straddling the window x-faces so the drift is
    # guaranteed to churn membership: 40 leavers just inside x=+16,
    # 40 entrants just outside x=-16 (inside the parking band, so they
    # are segment-B members from the migration repair onward)
    rng = np.random.default_rng(220)
    yz = rng.uniform(-10, 10, size=(80, 2)).astype(np.float32)
    pos_np[100:140, 0] = rng.uniform(15.3, 15.9, 40).astype(np.float32)
    pos_np[100:140, 1:] = yz[:40]
    pos_np[140:180, 0] = rng.uniform(-16.7, -16.1, 40).astype(np.float32)
    pos_np[140:180, 1:] = yz[40:]
    pos = pos.at[:, 100:180].set(jnp.asarray(pos_np[100:180].T))
    ker = pm2.fine_kernels(CFG, CFG2)
    st = pm_persist.init_sorted(pos, n_act, CFG)
    st, _ = pm_persist.accel_sorted(st, jnp.float32(1.0), CFG,
                                    n_active=n_act,
                                    cfg2=CFG2, kernels=ker)
    assert int(st.resorts) == 1           # migration into segments
    # coherent drift: everything slides +0.9 world units along x, so
    # particles near both x-faces of the window change membership while
    # staying inside their frozen classes (park absorbs the entrants)
    pos2 = st.pos + jnp.asarray([[0.9], [0.0], [0.0]], jnp.float32)
    st = st._replace(pos=pos2)
    st2, a_slot = pm_persist.accel_sorted(st, jnp.float32(1.0), CFG,
                                          n_active=n_act,
                                          cfg2=CFG2, kernels=ker)
    assert int(st2.resorts) == 1          # no additional repair
    ids = np.asarray(st2.ids)
    inv = np.argsort(ids)
    a_id = np.asarray(pm2.pm2_accel_ref(
        jnp.asarray(np.asarray(st2.pos)[:, inv]), n_act, 1.0, CFG, CFG2,
        kernels=ker))[:, :n]
    a_back = np.asarray(a_slot)[:, inv]
    scale = np.abs(a_id).max()
    assert np.abs(a_back[:, :n] - a_id).max() < 5e-3 * scale
    # sanity: the drift actually churned membership
    p1 = np.asarray(pos)[:, :n].T
    w0 = np.all((p1 >= -16) & (p1 < 16), axis=1)
    p2 = np.asarray(st2.pos)[:, inv][:, :n].T
    w1 = np.all((p2 >= -16) & (p2 < 16), axis=1)
    assert (w0 != w1).sum() > 20


@pytest.mark.slow
def test_persist_true_entrant_forces_repair():
    """A particle crossing the WHOLE parking band into the source set
    between repairs must force a repair that frame (frozen membership
    would otherwise exclude its fine contribution) — and the result
    stays exact."""
    from particle_sim_tpu.ops import pm_persist

    pos_np, pos, n_act = _scene(25)
    n = int(n_act)
    # plant particles just beyond the park band (window -16, park 1.0):
    # x in [-17.6, -17.1); a +1.3 drift lands them INSIDE the window
    rng = np.random.default_rng(250)
    pos_np[50:70, 0] = rng.uniform(-17.6, -17.1, 20).astype(np.float32)
    pos_np[50:70, 1:] = rng.uniform(-8, 8, (20, 2)).astype(np.float32)
    pos = pos.at[:, 50:70].set(jnp.asarray(pos_np[50:70].T))
    ker = pm2.fine_kernels(CFG, CFG2)
    st = pm_persist.init_sorted(pos, n_act, CFG)
    st, _ = pm_persist.accel_sorted(st, jnp.float32(1.0), CFG,
                                    n_active=n_act,
                                    cfg2=CFG2, kernels=ker)
    assert int(st.resorts) == 1
    pos2 = st.pos + jnp.asarray([[1.3], [0.0], [0.0]], jnp.float32)
    st = st._replace(pos=pos2)
    st2, a_slot = pm_persist.accel_sorted(st, jnp.float32(1.0), CFG,
                                          n_active=n_act,
                                          cfg2=CFG2, kernels=ker)
    assert int(st2.resorts) == 2          # entrant forced the repair
    ids = np.asarray(st2.ids)
    inv = np.argsort(ids)
    a_id = np.asarray(pm2.pm2_accel_ref(
        jnp.asarray(np.asarray(st2.pos)[:, inv]), n_act, 1.0, CFG, CFG2,
        kernels=ker))[:, :n]
    a_back = np.asarray(a_slot)[:, inv]
    scale = np.abs(a_id).max()
    assert np.abs(a_back[:, :n] - a_id).max() < 5e-3 * scale


@pytest.mark.slow
def test_persist_composite_centroid_window():
    """Centroid-tracking windows (window_min=None) ride the persistent
    order too — the traced origin shifts fine keys coherently, masked
    spans stay tight, and the result matches the identity-order
    reference."""
    from particle_sim_tpu.ops import pm_persist

    cfg2 = pm2.PM2Config(window_min=None, window_size=32.0, softening=0.75)
    pos_np, pos, n_act = _scene(23)
    n = int(n_act)
    ker = pm2.fine_kernels(CFG, cfg2)
    a_id = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, cfg2,
                                    kernels=ker))[:, :n]
    st = pm_persist.init_sorted(pos, n_act, CFG)
    st2, a_slot = pm_persist.accel_sorted(st, jnp.float32(1.0), CFG,
                                          n_active=n_act,
                                          cfg2=cfg2, kernels=ker)
    ids = np.asarray(st2.ids)
    a_back = np.zeros_like(np.asarray(a_slot))
    a_back[:, ids] = np.asarray(a_slot)
    scale = np.abs(a_id).max()
    assert np.abs(a_back[:, :n] - a_id).max() < 5e-3 * scale


@pytest.mark.slow
def test_persist_composition_parity():
    """pm2 composes with the persistent sorted state: both levels run
    sort-free on the coarse slot order (the fine level via masked
    spans) — and the result matches the identity-order two-level
    reference."""
    from particle_sim_tpu.ops import pm_persist

    pos_np, pos, n_act = _scene(8)
    n = int(n_act)
    ker = pm2.fine_kernels(CFG, CFG2)
    a_id = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, CFG2,
                                    kernels=ker))[:, :n]

    st = pm_persist.init_sorted(pos, n_act, CFG)
    st2, a_slot = pm_persist.accel_sorted(st, jnp.float32(1.0), CFG,
                                          n_active=n_act,
                                          cfg2=CFG2, kernels=ker)
    ids = np.asarray(st2.ids)
    a_back = np.zeros_like(np.asarray(a_slot))
    a_back[:, ids] = np.asarray(a_slot)
    scale = np.abs(a_id).max()
    assert np.abs(a_back[:, :n] - a_id).max() < 5e-3 * scale

    # engine wiring: the combination steps and stays finite
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine

    e = Engine(particle_count=1500, method=Method.PALLAS, interpret=True,
               pm=CFG, pm2=CFG2, pm_persist=True)
    e.step(psim.SimParams(delta_time=0.016, gravity=0.0))
    e.step(psim.SimParams(delta_time=0.016, gravity=0.0))
    e.ensure_identity_order()
    assert bool(jnp.isfinite(e.state.pos).all())
