"""Persistent cell-ordered PM: parity, disorder measure, repair triggers.

Oracle chain (SURVEY.md §4): accel_sorted must reproduce the per-frame
pm.pm_accel_ref (itself parity-tested against the direct O(N^2) sum) with
the acceleration permuted by the state's ids — in EVERY ordering regime:
freshly sorted, drifted-but-within-budget (no repair), and scrambled past
the budget (the lax.cond repair fires). The deposit and gather are the
same XLA scatter/gather in any order, so the two agree to f32
summation-order noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import particle_sim_tpu as psim
from particle_sim_tpu.core.params import PMConfig
from particle_sim_tpu.ops import physics, pm, pm_persist

CFG = PMConfig(softening=4.0, gradient="exact", boundary="isolated")


def _cloud(n, seed, radius=45.0, offset=(0, 0, 0)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
    return (x * r[:, None] + np.asarray(offset, np.float32)).astype(
        np.float32)


def _flat(pos_nx3, capacity=None):
    st = psim.ParticleState.from_arrays(
        pos_nx3, np.zeros_like(pos_nx3), np.zeros_like(pos_nx3),
        capacity=capacity)
    return jnp.asarray(st.pos.reshape(3, -1)), st.n_active


ATOL_REL = 1e-5   # summation order of the scatter-add, nothing else


def _ref_accel(pos_flat, n_active, cfg=CFG, masses=None):
    return np.asarray(pm.pm_accel_ref(pos_flat, n_active, 1.0,
                                      cfg.softening, cfg, masses=masses))


def _key(st, n_act, cfg=CFG):
    return np.asarray(pm_persist.cell_key(st.pos, st.ids < n_act, cfg))


def _assert_matches_ref(st, n_active, atol_rel=ATOL_REL, **kw):
    """accel_sorted == pm_accel_ref up to slot permutation."""
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n_active,
                                       **kw)
    a_ref = _ref_accel(_ids_order(st2), n_active)
    ids = np.asarray(st2.ids)
    scale = np.abs(a_ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(acc), a_ref[:, ids],
                               atol=atol_rel * scale)
    return st2, acc


def _ids_order(st):
    """Positions in identity order (the reference path's input)."""
    inv = jnp.zeros_like(st.ids).at[st.ids].set(
        jnp.arange(st.ids.shape[0], dtype=jnp.int32))
    return st.pos[:, inv]


@pytest.mark.slow
def test_parity_fresh_sort():
    pos, n_act = _flat(_cloud(1500, 0))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    # freshly sorted: keys are globally ordered, no repair can fire
    st2, _ = _assert_matches_ref(st, n_act)
    assert int(st2.resorts) == 0
    assert np.all(np.diff(_key(st2, n_act)) >= 0)


def test_parity_drifted_no_repair():
    """Small random drift stays within the pair budgets: no repair, and
    the result is exact."""
    pos, n_act = _flat(_cloud(2000, 1))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    rng = np.random.default_rng(2)
    drift = jnp.asarray(rng.normal(scale=0.3, size=st.pos.shape)
                        .astype(np.float32))
    st = st._replace(pos=st.pos + drift)
    st2, _ = _assert_matches_ref(st, n_act)
    assert int(st2.resorts) == 0


def test_repair_fires_on_scramble():
    """A global permutation destroys span locality: the pair budgets
    overflow, the cond repair fires, and the result is still exact."""
    pos, n_act = _flat(_cloud(2000, 3))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    perm = jnp.asarray(np.random.default_rng(4).permutation(
        st.pos.shape[1]).astype(np.int32))
    st = st._replace(pos=st.pos[:, perm], vel=st.vel[:, perm],
                     ids=st.ids[perm])
    st2, _ = _assert_matches_ref(st, n_act)
    assert int(st2.resorts) == 1


def test_partial_active_padding_inert():
    """Padding slots (ids >= n_active) must not deposit, gather zero, and
    stay inert even when poisoned with in-box garbage positions."""
    pos_np = _cloud(900, 5)
    st0 = psim.ParticleState.from_arrays(
        pos_np, np.zeros_like(pos_np), np.zeros_like(pos_np), capacity=2048)
    flat = jnp.asarray(st0.pos.reshape(3, -1))
    st = pm_persist.init_sorted(flat, st0.n_active, CFG)
    poison = jnp.where(st.ids[None] < st0.n_active, st.pos,
                       jnp.float32(1.5))
    st = st._replace(pos=poison)
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=st0.n_active)
    dead = np.asarray(st2.ids) >= 900
    assert np.all(np.asarray(acc)[:, dead] == 0.0)
    a_ref = _ref_accel(_ids_order(st2), st0.n_active)
    ids = np.asarray(st2.ids)
    scale = np.abs(a_ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(acc), a_ref[:, ids],
                               atol=ATOL_REL * scale)


@pytest.mark.slow
def test_step_sorted_matches_step_pm():
    """One integrated frame must equal pm.step_pm_ref modulo the slot
    permutation (identical accel + identical kick/step contract)."""
    n = 1024
    pos_np = _cloud(n, 6, radius=30.0)
    vel_np = np.random.default_rng(7).normal(
        scale=0.5, size=pos_np.shape).astype(np.float32)
    stp = psim.ParticleState.from_arrays(pos_np, vel_np,
                                         np.zeros_like(pos_np))
    pv = jnp.asarray(psim.SimParams(delta_time=0.016, gravity=0.0).pack())
    pairv = jnp.asarray(psim.PairwiseParams(1.0, CFG.softening).pack())
    planes_p = jnp.asarray(stp.pos)
    planes_v = jnp.asarray(stp.vel)

    p_ref, v_ref = pm.step_pm_ref(planes_p, planes_v, pv, pairv,
                                  stp.n_active, CFG)

    st = pm_persist.init_sorted(planes_p.reshape(3, -1), stp.n_active, CFG,
                                vel_flat=planes_v.reshape(3, -1))
    st2 = pm_persist.step_sorted(st, pv, pairv, stp.n_active, CFG)
    ids = np.asarray(st2.ids)
    p_ref = np.asarray(p_ref).reshape(3, -1)
    v_ref = np.asarray(v_ref).reshape(3, -1)
    np.testing.assert_allclose(np.asarray(st2.pos), p_ref[:, ids],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st2.vel), v_ref[:, ids],
                               rtol=0, atol=1e-4)


@pytest.mark.slow
def test_masses_ride_repairs():
    """Sorted source masses follow their particles through a repair."""
    pos, n_act = _flat(_cloud(1024, 8))
    masses = jnp.asarray(
        np.random.default_rng(9).uniform(0.5, 2.0, 1024).astype(np.float32))
    st = pm_persist.init_sorted(pos, n_act, CFG, masses=masses)
    perm = jnp.asarray(np.random.default_rng(10).permutation(
        1024).astype(np.int32))
    st = st._replace(pos=st.pos[:, perm], vel=st.vel[:, perm],
                     ids=st.ids[perm], masses=st.masses[perm])
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n_act)
    assert int(st2.resorts) == 1
    # masses still paired with their particles: sorted-by-ids masses
    # equal the originals
    ids = np.asarray(st2.ids)
    np.testing.assert_array_equal(
        np.asarray(st2.masses)[np.argsort(ids)], np.asarray(masses))
    a_ref = _ref_accel(
        _ids_order(st2), n_act,
        masses=jnp.asarray(np.asarray(st2.masses)[np.argsort(ids)]))
    scale = np.abs(a_ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(acc), a_ref[:, ids],
                               atol=ATOL_REL * scale)


def test_unsort_roundtrip():
    pos, n_act = _flat(_cloud(600, 11))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    (back,) = pm_persist.unsort(st, (st.pos,))
    np.testing.assert_array_equal(np.asarray(back), np.asarray(pos))


def test_periodic_boundary_parity():
    cfg = PMConfig(softening=4.0, gradient="exact", boundary="periodic")
    pos, n_act = _flat(_cloud(1200, 12))
    st = pm_persist.init_sorted(pos, n_act, cfg)
    st2, acc = pm_persist.accel_sorted(st, 1.0, cfg, n_active=n_act)
    a_ref = _ref_accel(_ids_order(st2), n_act, cfg)
    ids = np.asarray(st2.ids)
    scale = np.abs(a_ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(acc), a_ref[:, ids],
                               atol=ATOL_REL * scale)


def test_rejects_auto_box():
    cfg = PMConfig(softening=4.0, auto_box=True)
    pos, n_act = _flat(_cloud(512, 13))
    with pytest.raises(ValueError, match="static box"):
        pm_persist.init_sorted(pos, n_act, cfg)


def test_pick_chunk_budget():
    for g in pm_persist.SUPPORTED_GRIDS:
        geom = pm_persist._geom(g)
        sd, sg = pm_persist._slack(geom)
        for n in (512 * 4, 1000448, 16 * 1024 * 1024):
            c = pm_persist.pick_chunk(n, geom)
            assert n % c == 0
            nc = n // c
            assert (max(sd * nc + 4 * geom.n_tiles,
                        sg * nc + 2 * geom.n_tiles_g) + 2 <= 65536)
    # the geometry-scaled slack: +-1 z-cell of drift at G=128
    assert pm_persist._slack(pm_persist._GEOM128) == (20, 24)


def test_pick_chunk_odd_capacity():
    """A capacity no budget-fitting chunk divides (4,000,768 = 1024 *
    3907, the engine's padding of 4M particles) takes the largest
    dividing chunk instead of failing; non-multiples of 512 still fail."""
    assert pm_persist.pick_chunk(4_000_768) == 1024
    assert pm_persist.budgets(4_000_768 // 1024) == (
        pm_persist._MAX_PAIRS, pm_persist._MAX_PAIRS)
    with pytest.raises(ValueError, match="512"):
        pm_persist.pick_chunk(1000)


def test_budgets_clamped_and_sufficient():
    """Budgets are the doubled-SLACK drift headroom clamped to
    _MAX_PAIRS, and always cover a freshly-sorted order's totals (the repair
    guarantee). (At sparse tiny N the gather totals sit against the
    per-chunk tile-span floor, so only fit — not margin — is asserted.)"""
    for n in (2048, 61440):
        pos, n_act = _flat(_cloud(n - 7, 17))
        st = pm_persist.init_sorted(pos, n_act, CFG)
        cap = st.pos.shape[1]
        c = pm_persist.pick_chunk(cap)
        cd, cg = pm_persist.budgets(cap // c)
        assert cd <= pm_persist._MAX_PAIRS
        assert cg <= pm_persist._MAX_PAIRS
        dt, gt = pm_persist._pair_totals(jnp.asarray(_key(st, n_act)), c)
        assert int(dt) <= cd
        assert int(gt) <= cg


def test_pick_segment():
    """Local-repair segment sizing: multiple of the chunk, >= 8 chunks,
    >= 4 segments; ragged capacities that can't tile fall back to 0 (no
    local tier)."""
    assert pm_persist.pick_segment(16 * 1024 * 1024, 8192) == 65536
    assert pm_persist.pick_segment(131072, 512) == 32768
    assert pm_persist.pick_segment(1000448, 512) == 0   # 512*1954, 977 prime
    assert pm_persist.pick_segment(2048, 512) == 0      # too few segments


def test_sort_state_segmented_unit():
    """_sort_state(seg=...) sorts each segment independently, keeps
    payload rows paired with their keys, and leaves the dead tail at the
    END (dead keys are maximal and already live in the tail segments)."""
    rng = np.random.default_rng(21)
    n, seg, n_live = 4096, 1024, 3600
    key = np.where(np.arange(n) < n_live,
                   rng.integers(0, 10_000, n), pm_persist._GEOM128.sentinel)
    # scramble each segment internally (dead slots stay in tail segments)
    perm = np.concatenate([rng.permutation(seg) + i * seg
                           for i in range(n // seg)])
    key = key[perm].astype(np.int32)
    pos = rng.normal(size=(3, n)).astype(np.float32)
    ids = perm.astype(np.int32)
    st = pm_persist._sort_state(jnp.asarray(key), jnp.asarray(pos),
                                jnp.asarray(pos * 2.0), jnp.asarray(ids),
                                None, jnp.int32(1), seg=seg)
    k_out = np.asarray(key)[np.argsort(np.asarray(st.ids), kind="stable")]
    for i in range(n // seg):
        s = np.sort(key[i * seg:(i + 1) * seg])
        got_pos = np.asarray(st.pos)[:, i * seg:(i + 1) * seg]
        # segment sorted, and each slot's payload still matches its key
        kk = np.asarray(
            jax.lax.sort((jnp.asarray(key[i * seg:(i + 1) * seg]),
                          jnp.asarray(pos[:, i * seg:(i + 1) * seg][0])),
                         num_keys=1)[1])
        np.testing.assert_array_equal(
            np.sort(np.asarray(st.ids)[i * seg:(i + 1) * seg]),
            np.sort(ids[i * seg:(i + 1) * seg]))
        assert (np.diff(s) >= 0).all()
        np.testing.assert_allclose(got_pos[0], kk)
    # dead tail intact: the last (n - n_live) slots are exactly the dead ids
    assert set(np.asarray(st.ids)[n_live:].tolist()) == set(
        range(n_live, n))
    del k_out


@pytest.mark.slow
def test_local_repair_tier_within_segment_scramble(monkeypatch):
    """Scrambling WITHIN segments overflows the budgets but is fixable by
    the tier-1 segment-local sort: exactly one repair pass fires and the
    result is exact. (pick_segment is patched so the two-tier path runs
    at a CI-sized N.)"""
    monkeypatch.setattr(pm_persist, "pick_segment", lambda n, c: 2048)
    pos, n_act = _flat(_cloud(8192, 22))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    n = st.pos.shape[1]
    rng = np.random.default_rng(23)
    perm = np.concatenate([rng.permutation(2048) + i * 2048
                           for i in range(n // 2048)]).astype(np.int32)
    perm = jnp.asarray(perm)
    st = st._replace(pos=st.pos[:, perm], vel=st.vel[:, perm],
                     ids=st.ids[perm])
    st2, _ = _assert_matches_ref(st, n_act)
    assert int(st2.resorts) == 1          # tier 1 only
    # the repaired order is per-segment sorted
    key = _key(st2, n_act)
    for i in range(n // 2048):
        assert (np.diff(key[i * 2048:(i + 1) * 2048]) >= 0).all()


@pytest.mark.slow
def test_local_repair_escalates_to_global(monkeypatch):
    """A GLOBAL scramble defeats the local tier (segment key ranges all
    span the whole cloud): tier 1 fires, the re-derived totals still
    overflow, tier 2 runs the full sort — two repair passes, exact
    result, globally sorted order."""
    monkeypatch.setattr(pm_persist, "pick_segment", lambda n, c: 2048)
    pos, n_act = _flat(_cloud(8192, 24))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    perm = jnp.asarray(np.random.default_rng(25).permutation(
        st.pos.shape[1]).astype(np.int32))
    st = st._replace(pos=st.pos[:, perm], vel=st.vel[:, perm],
                     ids=st.ids[perm])
    st2, _ = _assert_matches_ref(st, n_act)
    assert int(st2.resorts) == 2          # local pass + full pass
    key = _key(st2, n_act)
    assert (np.diff(key) >= 0).all()


def test_base_kernels_args_bit_exact():
    """Routing the Hockney kernel spectra as runtime arguments
    (pm.base_kernels_device — at G=256 the baked constants alone are
    ~1.6 GB of program) is bit-exact vs the baked-constant path: same
    spectra, different plumbing."""
    from particle_sim_tpu.ops import pm as pm_mod

    pos, n_act = _flat(_cloud(4096, 31))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    bk = pm_mod.base_kernels_device(CFG, CFG.softening)
    _, a_baked = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n_act)
    _, a_args = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n_act,
                                        base_kernels=bk)
    np.testing.assert_array_equal(np.asarray(a_baked), np.asarray(a_args))


@pytest.mark.slow
def test_two_tier_false_skips_local_tier(monkeypatch):
    """``two_tier=False`` (for violent scenes) goes straight to the full
    sort: the SAME global scramble that costs the two-tier path two repair passes above repairs in ONE, with the
    identical exact result and a globally sorted order."""
    monkeypatch.setattr(pm_persist, "pick_segment", lambda n, c: 2048)
    pos, n_act = _flat(_cloud(8192, 24))
    st = pm_persist.init_sorted(pos, n_act, CFG)
    perm = jnp.asarray(np.random.default_rng(25).permutation(
        st.pos.shape[1]).astype(np.int32))
    st = st._replace(pos=st.pos[:, perm], vel=st.vel[:, perm],
                     ids=st.ids[perm])
    st2, _ = _assert_matches_ref(st, n_act, two_tier=False)
    assert int(st2.resorts) == 1          # full pass only, no tier 1
    key = _key(st2, n_act)
    assert (np.diff(key) >= 0).all()


G128 = pm_persist._GEOM128


def _window_bounds(geom=G128):
    """(lo, hi) base-row range per deposit window w = 2t + fam (the
    _hull docstring), as numpy arrays."""
    w = np.arange(2 * geom.n_tiles)
    t, fam = w >> 1, w & 1
    lo = np.maximum(t * pm_persist.T_ROWS - np.where(fam, geom.g + 1, 1), 0)
    hi = (t + 1) * pm_persist.T_ROWS - np.where(fam, geom.g, 0) - 1
    return lo, hi


def _incidences(kk, mask, chunk, geom=G128):
    """Brute force: {(window, chunk)} pairs whose rows intersect the
    live keys of ``mask`` in that chunk."""
    lo, hi = _window_bounds(geom)
    out = set()
    rows = kk >> geom.shift
    for s in range(kk.shape[0] // chunk):
        sl = slice(s * chunk, (s + 1) * chunk)
        m = mask[sl] & (kk[sl] < geom.sentinel)
        if not m.any():
            continue
        rmin, rmax = rows[sl][m].min(), rows[sl][m].max()
        for w in np.nonzero((rmax >= lo) & (rmin <= hi))[0]:
            out.add((int(w), s))
    return out


def _ranges(starts, counts):
    """{window: set of chunks} of per-class (start, count) hull lists."""
    got = {}
    for st_, c_ in zip(starts, counts):
        for w, (a, c) in enumerate(zip(np.asarray(st_), np.asarray(c_))):
            got.setdefault(w, []).extend(range(int(a), int(a) + int(c)))
    return got


def test_segmented_window_ranges_properties():
    """Brute-force check of _window_ranges_seg (the two-segment disorder
    measure) over random segmented orders: (1) every true (window,
    chunk) incidence of either segment part is inside that window's
    hulls, (2) no (window, chunk) pair is counted twice (the
    boundary-chunk dedup), (3) windows empty in both parts count one
    pad entry."""
    rng = np.random.default_rng(77)
    n, chunk = 8192, 512
    nc = n // chunk
    for trial in range(4):
        fine_b = int(rng.integers(1, n))
        keys = rng.integers(0, G128.sentinel, size=n).astype(np.int64)
        keys[rng.random(n) < 0.1] = G128.sentinel
        kk = np.concatenate([np.sort(keys[:fine_b]), np.sort(keys[fine_b:])])
        key = jnp.asarray(kk.astype(np.int32))
        spans_a, spans_b = pm_persist._seg_spans(key, chunk,
                                                 jnp.int32(fine_b))
        sa, ca, sb, cb = pm_persist._window_ranges_seg(spans_a, spans_b, nc,
                                                       G128)
        got = _ranges((sa, sb), (ca, cb))
        slot = np.arange(n)
        for w, chunks in got.items():
            real = [c for c in chunks if c < nc]
            assert len(real) == len(set(real)), (trial, w)
            if not real:
                assert chunks == [nc], (trial, w)     # one pad entry
        for mask in (slot < fine_b, slot >= fine_b):
            for w, s in _incidences(kk, mask, chunk):
                assert s in got[w], (trial, w, s)


def test_gather_tiles_cover_corner_rows():
    """_gather_tiles: each chunk's tile range covers every CIC corner row
    (r and r+1) of its live keys, in the gather's own T_ROWS_G blocking,
    and _pair_totals counts exactly two families per covered tile."""
    rng = np.random.default_rng(78)
    n, chunk = 8192, 512
    tg = pm_persist.T_ROWS_G
    for trial in range(4):
        keys = rng.integers(0, G128.sentinel, size=n).astype(np.int64)
        keys[rng.random(n) < 0.15] = G128.sentinel
        kk = np.sort(keys)
        key = jnp.asarray(kk.astype(np.int32))
        rmin, rmax = pm_persist._chunk_spans(key, chunk)
        t_lo, t_hi = (np.asarray(x) for x in
                      pm_persist._gather_tiles(rmin, rmax))
        rows = kk >> G128.shift
        for s in range(n // chunk):
            live = kk[s * chunk:(s + 1) * chunk] < G128.sentinel
            if not live.any():
                continue
            r = rows[s * chunk:(s + 1) * chunk][live]
            top = min(r.max() + 1, G128.rows_total - 1)
            assert t_lo[s] * tg <= r.min(), (trial, s)
            assert (t_hi[s] + 1) * tg > top, (trial, s)
        _, gt = pm_persist._pair_totals(key, chunk)
        assert int(gt) == int((2 * (t_hi - t_lo + 1)).sum())


@pytest.mark.parametrize(
    "grid", [32, 64, pytest.param(256, marks=pytest.mark.slow)])
def test_parity_other_grids(grid):
    """Grid generalization: the persistent path reproduces the per-frame
    reference at every SUPPORTED_GRIDS size, through all three ordering
    regimes — fresh sort, drifted-within-budget (no repair), and
    scrambled (repair fires). G=256 also exercises the scaled seg/dead
    key flags (periodic boundary there: the isolated Hockney solve
    doubles to a 512^3 grid — minutes of FFT per call on a host CPU)."""
    cfg = PMConfig(softening=4.0, gradient="exact",
                   boundary="periodic" if grid == 256 else "isolated",
                   grid=grid)
    pos, n_act = _flat(_cloud(1500, 30 + grid))
    st = pm_persist.init_sorted(pos, n_act, cfg)

    def check(st_, acc_):
        a_ref = _ref_accel(_ids_order(st_), n_act, cfg)
        scale = np.abs(a_ref).max() + 1e-12
        np.testing.assert_allclose(np.asarray(acc_),
                                   a_ref[:, np.asarray(st_.ids)],
                                   atol=ATOL_REL * scale)

    # fresh
    st2, acc = pm_persist.accel_sorted(st, 1.0, cfg, n_active=n_act)
    check(st2, acc)
    assert int(st2.resorts) == 0
    if grid == 256:
        return   # the drift/repair regimes are covered at 32/64/128
    # drifted within budget
    rng = np.random.default_rng(31)
    drift = jnp.asarray(rng.normal(scale=0.2, size=st2.pos.shape)
                        .astype(np.float32))
    st3, acc3 = pm_persist.accel_sorted(
        st2._replace(pos=st2.pos + drift), 1.0, cfg, n_active=n_act)
    check(st3, acc3)
    # scrambled: repair fires, still exact
    perm = jnp.asarray(rng.permutation(st3.pos.shape[1]).astype(np.int32))
    st4, acc4 = pm_persist.accel_sorted(
        st3._replace(pos=st3.pos[:, perm], vel=st3.vel[:, perm],
                     ids=st3.ids[perm]),
        1.0, cfg, n_active=n_act)
    assert int(st4.resorts) > int(st3.resorts)
    check(st4, acc4)


def test_engine_persist_grid_64():
    """Engine(pm_persist=True) accepts non-128 grids and tracks the
    per-frame engine."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine

    cfg = PMConfig(softening=4.0, gradient="exact", boundary="isolated",
                   grid=64)
    pv = psim.SimParams(delta_time=0.016, gravity=0.0)
    e = Engine(particle_count=1800, method=Method.PALLAS, pm=cfg,
               interpret=True, pm_persist=True)
    e_ref = Engine(particle_count=1800, method=Method.PALLAS, pm=cfg,
                   interpret=True, pm_persist=False)
    for _ in range(2):
        e.step(pv)
        e_ref.step(pv)
    assert e._persist is not None
    np.testing.assert_allclose(e.state.positions(),
                               e_ref.state.positions(), rtol=0, atol=5e-3)


def test_multi_window_ranges_properties():
    """Brute-force check of _window_ranges_multi (k+1-class order) over
    random class layouts: (1) every true (window, chunk) incidence of any
    class part is inside that window's hulls, (2) no (window, chunk) pair
    is counted twice (the cumulative boundary-chunk dedup, including the
    chain case of a class contained entirely inside one chunk), (3)
    windows empty in every class count one pad entry."""
    rng = np.random.default_rng(79)
    n, chunk = 8192, 512
    nc = n // chunk
    for trial in range(4):
        # three class boundaries; trial 2 forces a TINY middle class
        # (inside one chunk) to exercise the dedup chain
        if trial == 2:
            b0 = int(rng.integers(1, n - chunk))
            bounds_np = np.array([b0, b0 + int(rng.integers(1, 64)),
                                  min(b0 + 100, n)], np.int32)
        else:
            bounds_np = np.sort(rng.integers(0, n, size=3)).astype(np.int32)
        keys = rng.integers(0, G128.sentinel, size=n).astype(np.int64)
        keys[rng.random(n) < 0.1] = G128.sentinel
        lo = [0] + list(bounds_np)
        hi = list(bounds_np) + [n]
        kk = np.concatenate([np.sort(keys[l:h]) for l, h in zip(lo, hi)])
        key = jnp.asarray(kk.astype(np.int32))
        spans = pm_persist._seg_spans_multi(key, chunk,
                                            jnp.asarray(bounds_np))
        starts, counts = pm_persist._window_ranges_multi(spans, nc)
        got = _ranges(starts, counts)
        for w, chunks in got.items():
            real = [c for c in chunks if c < nc]
            assert len(real) == len(set(real)), (trial, w)
            if not real:
                assert chunks == [nc], (trial, w)
        slot = np.arange(n)
        for l, h in zip(lo, hi):
            for w, s in _incidences(kk, (slot >= l) & (slot < h), chunk):
                assert s in got[w], (trial, l, w, s)


@pytest.mark.parametrize("grid", [16, 32, 64])
@pytest.mark.parametrize("boundary", ["isolated", "periodic"])
@pytest.mark.parametrize("with_masses", [False, True])
def test_slot_order_deposit_matches_reference(grid, boundary, with_masses):
    """The persistent frame's deposit — pm.cic_deposit fed the slot-order
    cell coords and live/mass weights — equals cic_deposit_ref on the
    identity-order particles, for any permutation (the XLA scatter-add
    needs no sorted input)."""
    cfg = PMConfig(softening=4.0, grid=grid, boundary=boundary)
    pos, n_act = _flat(_cloud(1500, 40 + grid, radius=70.0))
    n = pos.shape[1]
    rng = np.random.default_rng(grid)
    masses = (jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
              if with_masses else None)
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))
    ids = jnp.arange(n, dtype=jnp.int32)[perm]
    w = (ids < n_act).astype(jnp.float32)
    if with_masses:
        w = w * masses[perm]
    rho = pm.cic_deposit(pm.cell_coords(pos[:, perm], cfg), w, grid,
                         boundary == "periodic")
    ref = pm.cic_deposit_ref(pos, n_act, cfg, masses=masses)
    np.testing.assert_allclose(np.asarray(rho), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    assert float(rho.sum()) == pytest.approx(float(w.sum()), rel=1e-5)


@pytest.mark.parametrize("grid", [16, 32, 64])
@pytest.mark.parametrize("boundary", ["isolated", "periodic"])
def test_slot_order_gather_matches_reference(grid, boundary):
    """pm.cic_gather at slot-order coords equals cic_gather_ref at
    identity order, permuted — including particles outside the box
    (clamped or wrapped by the boundary mode)."""
    cfg = PMConfig(softening=4.0, grid=grid, boundary=boundary)
    pos, _ = _flat(_cloud(1500, 50 + grid, radius=70.0))
    n = pos.shape[1]
    rng = np.random.default_rng(grid + 1)
    grids = jnp.asarray(rng.normal(size=(3, grid, grid, grid))
                        .astype(np.float32))
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))
    got = pm.cic_gather(grids, pm.cell_coords(pos[:, perm], cfg), grid,
                        boundary == "periodic")
    ref = pm.cic_gather_ref(grids, pos, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref)[:, perm],
                               rtol=0, atol=1e-6)


def test_parity_check_small():
    # the chip_smoke persistent-PM parity function, at a CPU-sized width
    from particle_sim_tpu.utils import parity
    r = parity.persist_pm(16384, 32)
    assert r["ok"], r


@pytest.mark.gpu
def test_parity_on_card():
    from particle_sim_tpu.utils import parity
    r = parity.persist_pm(4_000_000, 128)
    assert r["ok"], r
