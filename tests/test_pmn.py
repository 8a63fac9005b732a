"""Multi-level PM (ops/pm2.py pmn_accel*): telescoping accuracy, nesting,
parity, validation.

Oracle chain (SURVEY.md §4): the direct softened sum at the INNERMOST
softening is ground truth inside the innermost window; each added level
must strictly improve accuracy there (telescoping), and one-level pmn
must equal the two-level functions exactly (they are its special case).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from particle_sim_tpu.core.params import PMConfig
from particle_sim_tpu.ops import pairwise, pm, pm2

CFG = PMConfig(grid=128, box_min=(-64,) * 3, box_size=128.0, softening=3.0)
CORE = np.array([5.0, 4.0, -3.0], np.float32)
L1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=0.75)
L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.25)


def _scene(seed=0):
    """Halo (r=45) + clump (r=5) + dense core (r=1.2), clump/core around
    CORE so auto windows must track off-center."""
    rng = np.random.default_rng(seed)

    def cloud(n, radius, offset=(0, 0, 0)):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
        return (x * r[:, None] + np.asarray(offset, np.float32)).astype(
            np.float32)

    pos_np = np.concatenate([cloud(1500, 1.2, CORE), cloud(2000, 5.0, CORE),
                             cloud(1000, 45.0)])
    n = pos_np.shape[0]
    cap = -(-n // 512) * 512
    pos = jnp.asarray(np.concatenate(
        [pos_np, np.zeros((cap - n, 3), np.float32)]).T)
    return pos_np, pos, jnp.asarray(n, jnp.int32)


def _rms(a, ref, mask, mag):
    d = np.linalg.norm(a[:, mask] - ref[:, mask], axis=0)
    return np.sqrt((d ** 2).mean()) / mag


def test_three_level_accuracy_telescopes():
    """Inside the innermost window each added level strictly improves
    agreement with the direct sum at the INNERMOST softening — the
    telescoping composition resolves scales no single or two-level mesh
    can (0.25 world units = 4 innermost-fine cells here)."""
    pos_np, pos, n_act = _scene()
    n = int(n_act)
    a_dir = np.asarray(pairwise.pairwise_accel(pos, n_act, 1.0, 0.25))[:, :n]
    a_coarse = np.asarray(pm.pm_accel_ref(
        pos, n_act, 1.0, CFG.softening, CFG))[:, :n]
    a_1 = np.asarray(pm2.pmn_accel_ref(pos, n_act, 1.0, CFG, (L1,)))[:, :n]
    a_2 = np.asarray(pm2.pmn_accel_ref(pos, n_act, 1.0, CFG,
                                       (L1, L2)))[:, :n]

    core = np.linalg.norm(pos_np - CORE, axis=1) < 1.0
    assert core.sum() > 600
    mag = np.linalg.norm(a_dir[:, core], axis=0).mean()
    r_c = _rms(a_coarse, a_dir, core, mag)
    r_1 = _rms(a_1, a_dir, core, mag)
    r_2 = _rms(a_2, a_dir, core, mag)
    # each level cuts the core error by a large factor
    assert r_2 < 0.06, f"two-deep rms {r_2:.4f}"
    assert r_2 < r_1 / 3, (r_2, r_1)
    assert r_1 < r_c / 2, (r_1, r_c)


def test_one_level_is_pm2():
    """pmn with a single level reproduces the two-level functions
    exactly (they are its special case)."""
    pos_np, pos, n_act = _scene(1)
    a_pm2 = np.asarray(pm2.pm2_accel_ref(pos, n_act, 1.0, CFG, L1))
    a_pmn = np.asarray(pm2.pmn_accel_ref(pos, n_act, 1.0, CFG, (L1,)))
    np.testing.assert_array_equal(a_pm2, a_pmn)


def test_auto_windows_nest_and_track():
    """Auto origins: level 1 tracks the global centroid's neighborhood,
    level 2 the CORE (centroid of level-1 members), and every window
    nests inside its parent's source mask."""
    pos_np, pos, n_act = _scene(2)
    live = jnp.arange(pos.shape[1]) < n_act
    w1, w2 = pm2._nested_wmins(pos, live, CFG, (L1, L2), None)
    w1, w2 = np.asarray(w1), np.asarray(w2)
    assert (w2 >= w1 - 1e-5).all()
    assert (w2 + L2.window_size <= w1 + L1.window_size + 1e-5).all()
    # the inner window centers near the clump/core, not the halo centroid
    c2 = w2 + L2.window_size / 2
    assert np.linalg.norm(c2 - CORE) < 2.0, c2


def test_momentum_conserved():
    pos_np, pos, n_act = _scene(4)
    n = int(n_act)
    a = np.asarray(pm2.pmn_accel_ref(pos, n_act, 1.0, CFG,
                                     (L1, L2)))[:, :n]
    typical = np.abs(a).max()
    assert np.abs(a.sum(axis=1)).max() < 1e-3 * typical * n ** 0.5


def test_level_validation():
    pos_np, pos, n_act = _scene(5)
    with pytest.raises(ValueError, match="softening"):
        pm2.pmn_accel_ref(pos, n_act, 1.0, CFG,
                          (L1, pm2.PM2Config(None, 8.0, softening=0.75)))
    with pytest.raises(ValueError, match="nest"):
        pm2.pmn_accel_ref(pos, n_act, 1.0, CFG,
                          (L1, pm2.PM2Config(None, 40.0, softening=0.25)))
    with pytest.raises(ValueError, match="nest"):
        # static windows that do not overlap
        pm2.pmn_accel_ref(
            pos, n_act, 1.0, CFG,
            (pm2.PM2Config((-16.0,) * 3, 32.0, softening=0.75),
             pm2.PM2Config((20.0,) * 3, 8.0, softening=0.25)))
    with pytest.raises(ValueError, match="refinement level"):
        pm2.pmn_accel_ref(pos, n_act, 1.0, CFG, ())


def test_static_nested_windows_ok():
    """Valid static nesting passes validation and clamping is a no-op."""
    pos_np, pos, n_act = _scene(6)
    n = int(n_act)
    lv = (pm2.PM2Config((-16.0,) * 3, 32.0, softening=0.75),
          pm2.PM2Config((-4.0,) * 3, 8.0, softening=0.25))
    a = np.asarray(pm2.pmn_accel_ref(pos, n_act, 1.0, CFG, lv))[:, :n]
    assert np.isfinite(a).all()


def test_engine_multilevel():
    """Engine(pm2=(L1, L2)) runs the nested solver; the level stack
    survives a checkpoint roundtrip; unsupported compositions rejected."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine
    from particle_sim_tpu.io import checkpoint as ckpt

    e = Engine(particle_count=1500, method=Method.JNP, pm=CFG,
               pm2=(L1, L2))
    assert e.pm2 == (L1, L2)
    e.step(psim.SimParams(delta_time=0.016, gravity=0.0))
    assert bool(jnp.isfinite(e.state.pos).all())

    import os
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "c.npz")
        ckpt.save(path, e, step_index=7)
        e2, step = ckpt.load(path)
        assert step == 7 and e2.pm2 == (L1, L2)

    # a 1-tuple normalizes back to the plain two-level mode
    e1 = Engine(particle_count=1024, method=Method.JNP, pm=CFG, pm2=(L1,))
    assert e1.pm2 == L1

    # multi-level + pm_persist is a supported composition (the
    # k+1-class persistent order; stepping parity is covered by
    # test_persist_multi_engine_tracks_per_frame)
    ep = Engine(particle_count=1024, method=Method.JNP, pm=CFG,
                pm2=(L1, L2), pm_persist=True)
    assert ep.persist_resolved()
    # and the default keeps the per-frame pmn path for multi-level
    assert e.pm_persist is False


def test_cli_multilevel(tmp_path, capsys):
    """--pm2-size with several values builds the nested level stack
    (outermost first) and runs end-to-end; mismatched per-level
    softening counts are rejected."""
    import json

    from particle_sim_tpu.app.cli import main
    from particle_sim_tpu.io import checkpoint as ckpt

    ck = tmp_path / "c.npz"
    rc = main(["--count", "1500", "--steps", "2", "--method", "jnp",
               "--pm", "--pm-box", "-64", "-64", "-64", "128",
               "--pm-softening", "3.0",
               "--pm2-size", "32", "8",
               "--pm2-softening", "0.75", "0.25",
               "--checkpoint-every", "2", "--checkpoint", str(ck),
               "--stats-every", "0"])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["done"]
    e2, _ = ckpt.load(str(ck))
    assert isinstance(e2.pm2, tuple) and len(e2.pm2) == 2
    assert e2.pm2[0].window_size == 32.0
    assert e2.pm2[1].softening == 0.25

    with pytest.raises(SystemExit):
        main(["--count", "512", "--steps", "1", "--method", "jnp",
              "--pm2-size", "32", "8", "--pm2-softening", "0.5"])


@pytest.mark.slow
def test_persist_multi_matches_pmn():
    """Multi-level on the PERSISTENT k+1-class order
    (pm_persist.accel_sorted_multi): the first call migrates a fresh
    coarse-only state into the class order (exactly one repair), the
    second is the sort-free steady state, and both match the per-frame
    pmn reference up to the slot permutation (f32 summation order of
    the scatter-add deposits bounds the tolerance)."""
    from particle_sim_tpu.ops import pm_persist

    pos_np, pos, n_act = _scene(3)
    ker = pm2.levels_kernels(CFG, (L1, L2))
    st = pm_persist.init_sorted_multi(pos, n_act, CFG, 2)
    st1, a1 = pm_persist.accel_sorted_multi(
        st, jnp.float32(1.0), CFG, (L1, L2), n_active=n_act,
        interpret=True, kernels=ker)
    assert int(st1.resorts) == 1           # migration into classes
    b = np.asarray(st1.fine_b)
    assert 0 < b[0] <= b[1] < st1.pos.shape[1]
    st2, a2 = pm_persist.accel_sorted_multi(
        st1, jnp.float32(1.0), CFG, (L1, L2), n_active=n_act,
        interpret=True, kernels=ker)
    assert int(st2.resorts) == 1           # steady: no additional repair

    n = int(n_act)
    inv = np.zeros_like(np.asarray(st2.ids))
    inv[np.asarray(st2.ids)] = np.arange(st2.pos.shape[1])
    pos_id = jnp.asarray(np.asarray(st2.pos)[:, inv])
    a_ref = np.asarray(pm2.pmn_accel_ref(pos_id, n_act, 1.0, CFG, (L1, L2),
                                     kernels=ker))
    ids = np.asarray(st2.ids)
    scale = np.abs(a_ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(a2), a_ref[:, ids],
                               atol=3e-3 * scale)


@pytest.mark.slow
def test_persist_multi_engine_tracks_per_frame():
    """Engine(pm2=(L1, L2), pm_persist=True) steps the multi-level
    persistent path and tracks the per-frame multi-level engine."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine

    pos_np, _, _ = _scene(5)
    pv = psim.SimParams(delta_time=0.008, gravity=0.0)
    kw = dict(particle_count=pos_np.shape[0], method=Method.PALLAS,
              pm=CFG, interpret=True, pm2=(L1, L2))
    e = Engine(pm_persist=True, **kw)
    e_ref = Engine(**kw)
    assert e_ref.pm_persist is False      # the default is per-frame
    # identical initial state (engines generate the same sphere)
    for _ in range(2):
        e.step(pv)
        e_ref.step(pv)
    assert e._persist is not None
    assert e_ref._persist is None
    np.testing.assert_allclose(e.state.positions(),
                               e_ref.state.positions(), rtol=0, atol=5e-3)


def test_repair_budget_only_changes_order(monkeypatch):
    """The pair budgets decide only WHEN the persistent order is repaired:
    the XLA deposit/gather is exact in any slot order, so a state forced
    to repair on every call (budgets clamped to nothing) yields the same
    accelerations as one that never repairs."""
    from particle_sim_tpu.ops import pm_persist

    pos_np, pos, n_act = _scene(9)
    st = pm_persist.init_sorted_multi(pos, n_act, CFG, 1)
    ker = pm2.levels_kernels(CFG, (L1,))

    def accel(s):
        return pm_persist.accel_sorted_multi(
            s, jnp.float32(1.0), CFG, (L1,), kernels=ker, n_active=n_act)

    st, _ = accel(st)                  # migrates into the class order
    st_a, acc_a = accel(st)
    monkeypatch.setattr(pm_persist, "budgets_multi", lambda *a: (0, 0))
    st_b, acc_b = accel(st)
    assert int(st_b.resorts) == int(st.resorts) + 1
    a = np.asarray(pm_persist.unsort(st_a, (acc_a,))[0])
    b = np.asarray(pm_persist.unsort(st_b, (acc_b,))[0])
    n = int(n_act)
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b[:, :n], a[:, :n], rtol=0,
                               atol=1e-5 * np.abs(a[:, :n]).max())
