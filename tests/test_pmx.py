"""Window-exact short-range forces (ops/pmx.py): inside the tracked
window, the full stack must reproduce the direct O(N^2) sum at the
EXACT softening — which no mesh level can (the innermost mesh eps is
pinned at ~2.5 cells of its window).

Oracle chain (SURVEY.md §4): direct sum at eps_exact is ground truth
for member pairs deep inside the window; the jnp correction oracle
(exact_accel_ref) checks the compact-buffer fast path; momentum is
exact by pairwise antisymmetry."""

import jax.numpy as jnp
import numpy as np
import pytest

from particle_sim_tpu.core.params import PMConfig
from particle_sim_tpu.ops import pairwise, pm, pm2, pmx

CFG = PMConfig(grid=128, box_min=(-64,) * 3, box_size=128.0, softening=3.0)
CORE = np.array([6.0, -2.0, 3.0], np.float32)
EPS_X = 0.15


def _scene(seed=0, n_core=1200, n_halo=1600):
    rng = np.random.default_rng(seed)

    def cloud(n, radius, offset=(0, 0, 0)):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
        return (x * r[:, None] + np.asarray(offset, np.float32)).astype(
            np.float32)

    pos_np = np.concatenate([cloud(n_core, 1.5, CORE),
                             cloud(n_halo, 40.0)])
    n = pos_np.shape[0]
    cap = -(-n // 512) * 512
    pos = jnp.asarray(np.concatenate(
        [pos_np, np.zeros((cap - n, 3), np.float32)]).T)
    return pos_np, pos, jnp.asarray(n, jnp.int32)


CFGX = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=2048)


@pytest.mark.slow
def test_exact_inside_window_beats_mesh():
    """Core pairs feel the exact EPS_X force: rms vs the direct sum at
    EPS_X collapses from the mesh's smoothing error to the mesh's own
    realization error of the subtracted analytic kernel."""
    pos_np, pos, n_act = _scene()
    n = int(n_act)
    a_dir = np.asarray(pairwise.pairwise_accel(pos, n_act, 1.0,
                                               EPS_X))[:, :n]
    a_mesh = np.asarray(pm.pm_accel_ref(pos, n_act, 1.0, CFG.softening,
                                        CFG))[:, :n]
    # static window centered on the core: with NO refinement level to
    # ride, the auto origin tracks the GLOBAL centroid, which this
    # half-halo scene pulls off the core (auto-tracking through the
    # nested chain is exercised by test_composes_with_pm2_stack)
    cfgx = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=2048,
                         window_min=tuple(CORE - 4.0))
    acc, n_m = pmx.pmx_accel(pos, n_act, 1.0, CFG, (), cfgx,
                             )
    a_x = np.asarray(acc)[:, :n]
    assert int(n_m) == -1 or int(n_m) > 0

    core = np.linalg.norm(pos_np - CORE, axis=1) < 1.0
    assert core.sum() > 300
    mag = np.linalg.norm(a_dir[:, core], axis=0).mean()

    def rms(a):
        d = np.linalg.norm(a[:, core] - a_dir[:, core], axis=0)
        return np.sqrt((d ** 2).mean()) / mag

    assert rms(a_mesh) > 0.3            # the problem is real
    assert rms(a_x) < 0.05, f"exact-window rms {rms(a_x):.4f}"
    assert rms(a_x) < rms(a_mesh) / 10   # and pmx solves it


def test_fast_path_matches_ref():
    """Compact-buffer + two-pass pairwise kernel == jnp oracle."""
    pos_np, pos, n_act = _scene(1)
    n = pos.shape[1]
    live = jnp.arange(n) < n_act
    wmin = pm2.window_min(pos, None, CFGX, None, live=live)
    ref = np.asarray(pmx.exact_accel_ref(pos, live, CFGX, CFG.softening,
                                         wmin=wmin))
    fast, n_m = pmx.exact_accel(pos, live, CFGX, CFG.softening,
                                wmin=wmin, interpret=True)
    assert 0 < int(n_m) <= CFGX.capacity
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(fast), ref,
                               atol=2e-5 * scale)


def test_capacity_truncation_is_loud_not_wrong():
    """More members than capacity: the first ``capacity`` (slot order)
    keep the exact correction, the rest keep the pure mesh force, and
    the returned count exceeds the capacity so callers can warn."""
    pos_np, pos, n_act = _scene(2)
    n = pos.shape[1]
    live = jnp.arange(n) < n_act
    small = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=512)
    wmin = pm2.window_min(pos, None, small, None, live=live)
    corr, n_m = pmx.exact_accel(pos, live, small, CFG.softening,
                                wmin=wmin, interpret=True)
    assert int(n_m) > 512               # genuinely overflowing
    corr = np.asarray(corr)
    assert np.isfinite(corr).all()
    # truncated members (outside the first 512 by slot order) got zero
    member = np.asarray(pmx._member_mask(pos, wmin, small, live))
    member_slots = np.where(member)[0]
    dropped = member_slots[512:]
    assert np.abs(corr[:, dropped]).max() == 0.0
    kept = member_slots[:512]
    assert np.abs(corr[:, kept]).max() > 0.0


def test_momentum_antisymmetric():
    pos_np, pos, n_act = _scene(3)
    n = int(n_act)
    live = jnp.arange(pos.shape[1]) < n_act
    corr, _ = pmx.exact_accel(pos, live, CFGX, CFG.softening,
                              interpret=True)
    c = np.asarray(corr)[:, :n]
    typical = np.abs(c).max() + 1e-12
    assert np.abs(c.sum(axis=1)).max() < 1e-3 * typical * n ** 0.5


@pytest.mark.slow
def test_composes_with_pm2_stack():
    """pmx nests inside the innermost pm2 level; inside the exact
    window the stack tracks the direct sum at EPS_X better than the
    two-level mesh alone."""
    L1 = pm2.PM2Config(window_min=None, window_size=24.0, softening=0.8)
    pos_np, pos, n_act = _scene(4)
    n = int(n_act)
    a_dir = np.asarray(pairwise.pairwise_accel(pos, n_act, 1.0,
                                               EPS_X))[:, :n]
    a_2 = np.asarray(pm2.pmn_accel_ref(pos, n_act, 1.0, CFG,
                                       (L1,)))[:, :n]
    acc, _ = pmx.pmx_accel(pos, n_act, 1.0, CFG, (L1,), CFGX,
                           )
    a_x = np.asarray(acc)[:, :n]
    core = np.linalg.norm(pos_np - CORE, axis=1) < 1.0
    mag = np.linalg.norm(a_dir[:, core], axis=0).mean()

    def rms(a):
        d = np.linalg.norm(a[:, core] - a_dir[:, core], axis=0)
        return np.sqrt((d ** 2).mean()) / mag

    assert rms(a_x) < rms(a_2) / 3, (rms(a_x), rms(a_2))


def test_validation():
    with pytest.raises(ValueError, match="softening"):
        pmx.PMXConfig(window_size=8.0, softening=0.0)
    with pytest.raises(ValueError, match="512"):
        pmx.PMXConfig(window_size=8.0, softening=0.1, capacity=1000)
    pos_np, pos, n_act = _scene(5)
    with pytest.raises(ValueError, match="innermost"):
        pmx.pmx_accel(pos, n_act, 1.0, CFG, (), pmx.PMXConfig(
            window_size=8.0, softening=5.0))
    with pytest.raises(ValueError, match="nest"):
        pmx.pmx_accel(pos, n_act, 1.0, CFG,
                      (pm2.PM2Config(None, 16.0, softening=0.8),),
                      pmx.PMXConfig(window_size=24.0, softening=0.1))


def test_engine_and_checkpoint(tmp_path):
    """Engine(pmx=...) steps via step_pmx_jit; the config survives a
    checkpoint roundtrip; unsupported compositions are rejected."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine
    from particle_sim_tpu.io import checkpoint as ckpt

    e = Engine(particle_count=1500, method=Method.JNP, pm=CFG, pmx=CFGX)
    assert e.pm_persist is False
    e.step(psim.SimParams(delta_time=0.016, gravity=0.0))
    assert bool(jnp.isfinite(e.state.pos).all())

    path = str(tmp_path / "x.npz")
    ckpt.save(path, e, step_index=3)
    e2, step = ckpt.load(path)
    assert step == 3 and e2.pmx == CFGX
    e2.step(psim.SimParams(delta_time=0.016, gravity=0.0))

    with pytest.raises(ValueError, match="pm="):
        Engine(particle_count=1024, method=Method.JNP, pmx=CFGX)
    with pytest.raises(ValueError, match="MULTI-level"):
        # pmx + persist needs the multi-level class order (pm2 tuple)
        Engine(particle_count=1024, method=Method.JNP, pm=CFG, pmx=CFGX,
               pm_persist=True)


def test_set_pm2_and_set_pmx_validate_at_call_site():
    """single-level stacks get the same validation as tuples,
    and a stack swap incompatible with the installed pmx window raises
    in set_pm2 — never at trace time inside engine.step()."""
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine

    e = Engine(particle_count=1500, method=Method.JNP, pm=CFG, pmx=CFGX)
    # single-level stack with softening >= coarse: rejected eagerly
    with pytest.raises(ValueError, match="softening"):
        e.set_pm2(pm2.PM2Config(window_min=None, window_size=24.0,
                                softening=5.0))
    # a level the 8-unit exact window cannot nest inside: rejected
    with pytest.raises(ValueError, match="nest"):
        e.set_pm2(pm2.PM2Config(window_min=None, window_size=6.0,
                                softening=0.8))
    # valid stack applies (and the pmx cross-check passes)
    L = pm2.PM2Config(window_min=None, window_size=24.0, softening=0.8)
    e.set_pm2(L)
    assert e.pm2 == L
    # pmx softening must stay below the innermost mesh softening
    with pytest.raises(ValueError, match="innermost"):
        e.set_pmx(pmx.PMXConfig(window_size=8.0, softening=1.0))
    assert e.pmx == CFGX          # rejected swap keeps the old window
    e.set_pmx(None)
    assert e.pmx is None

    # persist mode: dropping below a multi-level stack while pmx rides
    # the class order is rejected at the call site
    L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.4)
    cfgx = pmx.PMXConfig(window_size=4.0, softening=EPS_X, capacity=1024)
    ep = Engine(particle_count=1024, method=Method.JNP, pm=CFG,
                pm2=(L, L2), pmx=cfgx, pm_persist=True)
    with pytest.raises(ValueError, match="MULTI-level"):
        ep.set_pm2(L)
    with pytest.raises(ValueError, match="MULTI-level"):
        ep.set_pm2(None)
    assert ep.pm2 == (L, L2)


def test_truncation_overflow_is_warned(caplog):
    """an overflowing exact window must LOG, not silently
    degrade — the engine polls the device counters and warns once per
    episode; pmx_member_count() is the on-demand readout."""
    import logging

    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine

    pos_np, _, _ = _scene(2)
    small = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=512,
                          window_min=tuple(CORE - 4.0))
    e = Engine(particle_count=pos_np.shape[0], method=Method.JNP,
               pm=CFG, pmx=small)
    e.state = psim.ParticleState.from_arrays(
        pos_np, np.zeros_like(pos_np), np.full_like(pos_np, 0.5),
        capacity=e.capacity)
    pv = psim.SimParams(delta_time=0.004, gravity=0.0)
    with caplog.at_level(logging.WARNING,
                         logger="particle_sim_tpu.engine.engine"):
        e.step(pv)
    n_mem, n_corr = e.pmx_member_count()
    assert n_mem > 512 >= n_corr      # genuinely overflowing
    assert any("pmx window overflow" in r.message for r in caplog.records)
    # steady overflow: no repeat warning within the episode
    caplog.clear()
    e._pmx_check_at = 0
    with caplog.at_level(logging.WARNING,
                         logger="particle_sim_tpu.engine.engine"):
        e.step(pv)
    assert not any("pmx window overflow" in r.message
                   for r in caplog.records)


def test_persist_pmx_steady_frame_has_no_sort():
    """on the persistent multi-level
    order the window-exact member buffer is ONE dynamic slice of the
    contiguous innermost class — the traced frame contains ZERO sort
    primitives outside the repair conds (ops/pmx.py's per-frame path
    pays a flag sort + un-sort every frame; this path pays none)."""
    import jax

    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import PairwiseParams
    from particle_sim_tpu.ops import pm_persist

    L1 = pm2.PM2Config(window_min=None, window_size=24.0, softening=0.8)
    L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.4)
    cfgx = pmx.PMXConfig(window_size=4.0, softening=EPS_X, capacity=512)
    _, pos, n_act = _scene(8)
    st = pm_persist.init_sorted_multi(pos, n_act, CFG, 2)
    pv = jnp.asarray(psim.SimParams(delta_time=0.008).pack())
    pp = jnp.asarray(PairwiseParams(1.0, CFG.softening).pack())
    ker = pm2.levels_kernels(CFG, (L1, L2))

    def frame(s, k):
        return pm_persist.step_sorted(s, pv, pp, n_act, CFG,
                                      interpret=True, cfg2=(L1, L2),
                                      kernels=k, cfgx=cfgx)

    jaxpr = jax.make_jaxpr(frame)(st, ker)

    def _subjaxprs(v):
        # duck-typed: ClosedJaxpr has .jaxpr, Jaxpr has .eqns (keeps
        # the walker working across jax.core/jax.extend.core moves)
        if hasattr(v, "jaxpr"):
            yield v.jaxpr
        elif hasattr(v, "eqns"):
            yield v
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from _subjaxprs(x)

    found = []

    def walk(jx, in_cond):
        for eqn in jx.eqns:
            is_cond = eqn.primitive.name == "cond"
            if eqn.primitive.name == "sort" and not in_cond:
                found.append(eqn)
            for val in eqn.params.values():
                for sub in _subjaxprs(val):
                    walk(sub, in_cond or is_cond)

    walk(jaxpr.jaxpr, False)
    assert not found, f"steady-state sorts found: {found}"
    # sanity: the repair path (inside conds) still sorts — the check
    # above must not be vacuous
    alls = []

    def walk_all(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "sort":
                alls.append(eqn)
            for val in eqn.params.values():
                for sub in _subjaxprs(val):
                    walk_all(sub)

    walk_all(jaxpr.jaxpr)
    assert alls, "expected repair-cond sorts in the traced frame"


@pytest.mark.slow
def test_pmx_mesh_matches_single_device():
    """multi-device pmx — each shard contributes
    capacity/n_dev slots of its innermost class to one all_gather'd
    member buffer; the sharded flagship composition (persistent
    multi-level + exact window) must match the single-device step in
    identity order, and the psum'd counts must agree."""
    import jax

    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import PairwiseParams
    from particle_sim_tpu.ops import pm_persist
    from particle_sim_tpu.parallel import mesh as mesh_lib, pm_persist_dp

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device (virtual) platform")
    mesh = mesh_lib.make_mesh()
    n_dev = int(mesh.devices.size)

    # dense core + halo so the nested windows and the exact window all
    # have members; N a multiple of 512 * n_dev
    n = 512 * n_dev
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = np.where(np.arange(n) % 3 == 0,
                 1.5 * rng.random(n) ** (1 / 3),
                 40.0 * rng.random(n) ** (1 / 3)).astype(np.float32)
    pos = jnp.asarray((x * r[:, None] + np.where(
        np.arange(n)[:, None] % 3 == 0, CORE, 0.0)).T.astype(np.float32))
    vel = jnp.zeros_like(pos)
    n_act = jnp.int32(n)

    L1 = pm2.PM2Config(window_min=None, window_size=24.0, softening=0.8)
    L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.4)
    cfgx = pmx.PMXConfig(window_size=4.0, softening=EPS_X,
                         capacity=512 * n_dev)
    ker = pm2.levels_kernels(CFG, (L1, L2))
    pv = jnp.asarray(psim.SimParams(delta_time=0.008).pack())
    pp = jnp.asarray(PairwiseParams(1.0, CFG.softening).pack())

    init = pm_persist_dp.make_persist_init(mesh, CFG, n_levels=2)
    carry = init(pos, vel, n_act)
    step = pm_persist_dp.make_persist_pm_step(mesh, CFG, interpret=True,
                                              cfg2=(L1, L2), cfgx=cfgx)
    out = step(*carry, pv, pp, n_act, ker)
    sp, sv, ids, _, _, counts = out
    assert counts.shape == (2,)

    st = pm_persist.init_sorted_multi(pos, n_act, CFG, 2)
    st1, counts1 = pm_persist.step_sorted(
        st, pv, pp, n_act, CFG, interpret=True, cfg2=(L1, L2),
        kernels=ker, cfgx=cfgx)

    def ident(ids_, arr):
        out_ = np.zeros_like(arr)
        out_[..., np.asarray(ids_)] = arr
        return out_

    v_dp = ident(ids, np.asarray(sv))
    v_1 = ident(np.asarray(st1.ids), np.asarray(st1.vel))
    scale = np.abs(v_1).max() + 1e-12
    np.testing.assert_allclose(ident(ids, np.asarray(sp)),
                               ident(np.asarray(st1.ids),
                                     np.asarray(st1.pos)),
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(v_dp, v_1, rtol=0,
                               atol=max(0.02 * scale, 2e-3))
    # counts: same global window, psum'd member totals ~ the
    # single-device ones (float centroid rounding may move a boundary
    # particle)
    c_dp, c_1 = np.asarray(counts), np.asarray(counts1)
    assert c_1[0] > 0 and abs(int(c_dp[0]) - int(c_1[0])) <= 2
    assert abs(int(c_dp[1]) - int(c_1[1])) <= 2


@pytest.mark.slow
def test_cli_pmx(tmp_path):
    """--pmx-size implies --pm and runs end-to-end."""
    from particle_sim_tpu.app.cli import main

    rc = main(["--count", "600", "--steps", "2", "--method", "jnp",
               "--pmx-size", "8", "--pmx-softening", "0.2",
               "--pmx-capacity", "1024", "--stats-every", "0"])
    assert rc == 0


@pytest.mark.slow
def test_persist_multilevel_with_pmx():
    """The full flagship composition: multi-level PM on the persistent
    k+1-class order TERMINATED by the window-exact correction
    (accel_sorted_multi cfgx — the contiguous innermost class makes the
    member buffer one dynamic slice). Must track the per-frame
    pmx path (engine-level, 2 steps) and reject non-multi configs."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine

    L1 = pm2.PM2Config(window_min=None, window_size=24.0, softening=0.8)
    L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.4)
    cfgx = pmx.PMXConfig(window_size=4.0, softening=EPS_X, capacity=2048)
    pos_np, _, _ = _scene(7, n_core=1400, n_halo=1000)
    pv = psim.SimParams(delta_time=0.008, gravity=0.0)
    kw = dict(method=Method.PALLAS, pm=CFG, interpret=True,
              pm2=(L1, L2), pmx=cfgx)

    def seed_engine(**ekw):
        e = Engine(particle_count=pos_np.shape[0], **ekw)
        st = psim.ParticleState.from_arrays(
            pos_np, np.zeros_like(pos_np), np.full_like(pos_np, 0.5),
            capacity=e.capacity)
        e.state = st
        return e

    e_per = seed_engine(pm_persist=True, **kw)
    e_ref = seed_engine(**kw)                 # per-frame pmx path
    assert e_ref.pm_persist is False
    for _ in range(2):
        e_per.step(pv)
        e_ref.step(pv)
    assert e_per._persist is not None
    np.testing.assert_allclose(e_per.state.positions(),
                               e_ref.state.positions(), rtol=0, atol=5e-3)
    # guard against a vacuous pass: the exact window must actually have
    # corrected something (positions differ from a mesh-only engine)
    e_mesh = seed_engine(method=Method.PALLAS, pm=CFG, interpret=True,
                         pm2=(L1, L2))
    for _ in range(2):
        e_mesh.step(pv)
    assert np.abs(e_per.state.positions()
                  - e_mesh.state.positions()).max() > 1e-4

    # persist + pmx without a multi-level stack is rejected loudly
    with pytest.raises(ValueError, match="MULTI-level"):
        Engine(particle_count=1024, method=Method.JNP, pm=CFG,
               pmx=cfgx, pm_persist=True)
