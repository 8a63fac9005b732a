"""Engine integration of the persistent cell-ordered PM mode: outputs stay
in identity order, lifecycle mutations invalidate the sorted mirror, and
the trajectory matches the per-frame engine."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import particle_sim_tpu as psim
from particle_sim_tpu.core.params import Method, PMConfig, SimParams
from particle_sim_tpu.engine import Engine

CFG = PMConfig(softening=4.0, gradient="exact", boundary="isolated")
PARAMS = SimParams(delta_time=0.016, gravity=0.0)


def _engine(persist, **kw):
    return Engine(particle_count=2000, method=Method.PALLAS, pm=CFG,
                  interpret=True, pm_persist=persist, **kw)


@pytest.mark.slow
def test_trajectory_matches_sorted_path():
    e_ref = _engine(False)
    e_per = _engine(True)
    p0 = e_per.state.positions().copy()
    for _ in range(3):
        e_ref.step(PARAMS)
        e_per.step(PARAMS)
    p_ref = e_ref.state.positions()
    p_per = e_per.state.positions()  # property rebuilds identity order
    # guard against the vacuous-pass failure mode: the persist engine
    # must have actually MOVED (a stale-state read would return p0), and
    # its motion must match the reference's much more closely than the
    # motion magnitude itself
    moved = np.abs(p_ref - p0).max()
    assert moved > 0.0
    # same deposit/solve/gather in another order: the scatter-add's
    # summation order bounds the divergence per kick
    err = np.abs(p_per - p_ref).max()
    assert err < 5e-3
    assert err < 0.25 * moved
    assert np.abs(p_per - p0).max() > 0.5 * moved


@pytest.mark.slow
def test_frame_arrays_pairing():
    """Streamed points may arrive in ANY order (the client draws an
    order-independent point cloud; the persist engine serves the stream
    straight from the sorted planes to skip the per-frame identity
    un-sort), but each point's color must still pair with its OWN
    particle: un-permute by the persist state's ids and compare against
    the reference engine's identity-ordered stream."""
    e_per = _engine(True)
    e_ref = _engine(False)
    e_per.step(PARAMS)
    e_ref.step(PARAMS)
    pos_p, rgba_p = e_per.frame_arrays(PARAMS)
    pos_r, rgba_r = e_ref.frame_arrays(PARAMS)
    n = pos_p.shape[1]
    assert e_per._identity_dirty  # the stream must NOT have paid un-sort
    ids = np.asarray(e_per._persist.ids)[:n]
    assert sorted(ids) == list(range(n))  # live slots are a prefix
    pos_pi = np.zeros_like(pos_p)
    pos_pi[:, ids] = pos_p
    rgba_pi = np.zeros_like(rgba_p)
    rgba_pi[ids] = rgba_p
    np.testing.assert_allclose(pos_pi, pos_r, rtol=0, atol=5e-3)
    assert abs(rgba_pi.astype(int) - rgba_r.astype(int)).max() <= 1


@pytest.mark.slow
def test_resize_and_reset_invalidate_mirror():
    e = _engine(True)
    e.step(PARAMS)
    assert e._persist is not None
    e.resize(2600)
    assert e._persist is None
    assert e.particle_count == 2600
    e.step(PARAMS)
    assert e._persist is not None
    e.reset()
    assert e._persist is None
    e.step(PARAMS)
    assert bool(jnp.isfinite(e.state.pos).all())


def test_solver_switch_falls_back():
    """Clearing pm mid-run (server 'solver off' event) must sync identity
    order once and continue on the plain attractor path."""
    e = _engine(True)
    e.step(PARAMS)
    e.pm = None
    e.pairwise = None
    e.step(PARAMS)  # no crash; identity order restored internally
    assert not e._identity_dirty
    assert bool(jnp.isfinite(e.state.pos).all())


def test_checkpoint_roundtrip_identity(tmp_path):
    from particle_sim_tpu.io import checkpoint as ckpt
    e = _engine(True)
    e.step(PARAMS)
    path = str(tmp_path / "per.npz")
    ckpt.save(path, e, step_index=1)
    e2, step = ckpt.load(path, method=Method.JNP)
    assert step == 1
    assert e2.pm_persist  # solver mode survives the roundtrip
    np.testing.assert_allclose(e2.state.positions(),
                               e.state.positions(), atol=1e-6)


@pytest.mark.parametrize("pm", [None, CFG])
def test_checkpoint_with_retired_auto_mode_loads(tmp_path, pm):
    """Checkpoints written while pm_persist had an "auto" mode (saved for
    every engine, with or without PM) resume on the per-frame default."""
    import json

    from particle_sim_tpu.io import checkpoint as ckpt
    path = str(tmp_path / "old.npz")
    ckpt.save(path, Engine(particle_count=2000, method=Method.JNP, pm=pm))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    meta["pm_persist"] = "auto"
    arrays["meta"] = json.dumps(meta)
    np.savez_compressed(path, **arrays)
    e2, _ = ckpt.load(path)
    assert e2.pm_persist is False and e2.pm == pm
    assert not e2.persist_resolved()


def test_two_tier_flag_plumbs(tmp_path):
    """Engine(two_tier=False) — the full-sort-only repair strategy for
    violent scenes — is carried on the engine and rides checkpoints (no
    stepping: the repair-path physics parity is the slow-tier test
    below)."""
    from particle_sim_tpu.io import checkpoint as ckpt
    e_full = _engine(True, two_tier=False)
    assert _engine(True).two_tier and not e_full.two_tier
    path = str(tmp_path / "full.npz")
    ckpt.save(path, e_full, step_index=0)
    e2, _ = ckpt.load(path, method=Method.PALLAS, interpret=True)
    assert e2.two_tier is False
    assert e2.pm_persist


@pytest.mark.slow
def test_two_tier_false_matches_trajectory():
    """two_tier=False steps to the same trajectory as the default
    two-tier engine: repair strategy is an ordering choice, never a
    physics one."""
    e_tt = _engine(True)
    e_full = _engine(True, two_tier=False)
    for _ in range(2):
        e_tt.step(PARAMS)
        e_full.step(PARAMS)
    np.testing.assert_allclose(e_full.state.positions(),
                               e_tt.state.positions(), atol=1e-5)


def test_pm_persist_default_is_per_frame():
    """With no pm_persist, a PM engine runs the per-frame path at every
    size (no count-based switch); pm_persist=True runs the persistent
    order, and both agree on the trajectory."""
    e = Engine(particle_count=2000, method=Method.PALLAS, pm=CFG,
               interpret=True)
    assert e.pm_persist is False
    assert not e.persist_resolved()
    e.resize(4096)
    assert not e.persist_resolved()
    e2 = Engine(particle_count=4096, method=Method.PALLAS, pm=CFG,
                interpret=True, pm_persist=True)
    st = e.state
    e2.state = psim.ParticleState(pos=jnp.array(st.pos), vel=jnp.array(st.vel),
                                  init_color=st.init_color,
                                  n_active=st.n_active)
    assert e2.persist_resolved()
    for _ in range(2):
        e.step(PARAMS)
        e2.step(PARAMS)
    assert e._persist is None and e2._persist is not None
    np.testing.assert_allclose(e.state.positions(), e2.state.positions(),
                               atol=1e-4)


def test_rejects_bad_config():
    with pytest.raises(ValueError, match="pm_persist"):
        Engine(particle_count=1000, method=Method.JNP, pm=None,
               interpret=True, pm_persist=True)
    with pytest.raises(ValueError, match="static box"):
        Engine(particle_count=1000, method=Method.JNP,
               pm=PMConfig(softening=2.0, auto_box=True),
               interpret=True, pm_persist=True)


@pytest.mark.slow
def test_persist_with_mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device platform")
    from particle_sim_tpu.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh()
    n = mesh.devices.size * 1024
    masses = np.ones(n, np.float32)
    e = Engine(particle_count=n,
               method=Method.PALLAS, pm=CFG, interpret=True,
               pm_persist=True, mesh=mesh, masses=masses)
    e_ref = Engine(particle_count=n,
                   method=Method.PALLAS, pm=CFG, interpret=True,
                   mesh=mesh, masses=masses)
    for _ in range(2):
        e.step(PARAMS)
        e_ref.step(PARAMS)
    np.testing.assert_allclose(e.state.positions(),
                               e_ref.state.positions(), rtol=0, atol=5e-3)


@pytest.mark.slow
def test_jnp_method_persist_runs():
    """A Method.JNP engine with pm_persist (e.g. a checkpoint resumed on
    a CPU box) must step: the persistent order runs on plain XLA."""
    from particle_sim_tpu.core.params import Method

    e = Engine(particle_count=900, method=Method.JNP, pm=CFG,
               pm_persist=True)
    e.step(PARAMS)
    e.step(PARAMS)
    assert bool(jnp.isfinite(e.state.pos).all())
    assert e._persist is not None


@pytest.mark.slow
def test_cli_pm_persist_implies_pm(tmp_path):
    """--pm-persist without --pm must run (the flag implies the PM
    solver, matching the server's behavior) instead of crashing."""
    from particle_sim_tpu.app.cli import main

    rc = main(["--count", "600", "--steps", "2", "--method", "jnp",
               "--pm-persist", "--stats-every", "0"])
    assert rc == 0


@pytest.mark.slow
def test_persist_with_mesh_two_level():
    """Multi-device pm2 rides the persist path: engine(mesh, pm_persist,
    pm2) steps and tracks the single-device two-level persist engine."""
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device platform")
    from particle_sim_tpu.ops import pm2 as pm2_mod
    from particle_sim_tpu.parallel import mesh as mesh_lib

    cfg2 = pm2_mod.PM2Config(window_min=None, window_size=32.0,
                             softening=1.0)
    mesh = mesh_lib.make_mesh()
    n = mesh.devices.size * 1024
    e = Engine(particle_count=n, method=Method.PALLAS, pm=CFG,
               interpret=True, pm_persist=True, mesh=mesh, pm2=cfg2)
    e_ref = Engine(particle_count=n, method=Method.PALLAS, pm=CFG,
                   interpret=True, pm_persist=True, pm2=cfg2)
    for _ in range(2):
        e.step(PARAMS)
        e_ref.step(PARAMS)
    np.testing.assert_allclose(e.state.positions(),
                               e_ref.state.positions(), rtol=0, atol=5e-3)


def test_mesh_pm2_auto_promotes_persist():
    """Multi-device pm2 only exists on the persist path; an eligible
    config with no pm_persist is promoted to pm_persist=True
    (engine.py pm2+mesh handling), while an INELIGIBLE config (auto_box,
    or an explicit pm_persist=False) still fails loudly."""
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device platform")
    from particle_sim_tpu.ops import pm2 as pm2_mod
    from particle_sim_tpu.parallel import mesh as mesh_lib

    cfg2 = pm2_mod.PM2Config(window_min=None, window_size=32.0,
                             softening=1.0)
    mesh = mesh_lib.make_mesh()
    e = Engine(particle_count=2048, method=Method.PALLAS, pm=CFG,
               interpret=True, mesh=mesh, pm2=cfg2)
    assert e.pm_persist is True          # unset → promoted
    assert e.persist_resolved()
    # ineligible coarse config (auto_box) cannot ride the persist path
    with pytest.raises(ValueError, match="persist|static box"):
        Engine(particle_count=2048, method=Method.PALLAS,
               pm=PMConfig(softening=4.0, auto_box=True),
               interpret=True, mesh=mesh, pm2=cfg2)
    # an explicit pm_persist=False with mesh+pm2 is a contradiction
    with pytest.raises(ValueError, match="pm_persist"):
        Engine(particle_count=2048, method=Method.PALLAS, pm=CFG,
               interpret=True, mesh=mesh, pm2=cfg2, pm_persist=False)


@pytest.mark.slow
def test_render_from_sorted_planes_skips_unsort():
    """Velocity/position color modes rasterize straight from the sorted
    planes (the raster is order-independent); the frame must match the
    identity-order render, and the identity mirror must stay dirty (no
    un-sort paid). Mode 0 still rebuilds identity order."""
    from particle_sim_tpu.render.camera import Camera

    cam = Camera(aspect=1.0)
    pv_vel = SimParams(delta_time=0.016, gravity=0.0, color_mode=1)
    e = _engine(True)
    for _ in range(2):
        e.step(pv_vel)
    assert e._identity_dirty
    img_fast = e.render_frame(cam, pv_vel, width=64, height=64)
    assert e._identity_dirty          # sorted-plane path: no un-sort
    # reference: force the identity rebuild, render the same frame
    e.ensure_identity_order()
    assert not e._identity_dirty
    img_ref = e.render_frame(cam, pv_vel, width=64, height=64)
    # commutative additive blend: only summation order differs
    assert abs(img_fast.astype(int) - img_ref.astype(int)).max() <= 1
    # mode 0 (ORIGINAL — the reference default) pairs points with
    # init_color; the persist state carries it pre-paired as col24, so
    # the DEFAULT config is ALSO sort-free.
    # Divergence budget: u8 col24 quantization (<=0.5/255 per point,
    # pre-brightness) on top of the additive blend.
    e2 = _engine(True)
    e2.step(pv_vel)
    assert e2._identity_dirty
    pv0 = SimParams(delta_time=0.016, gravity=0.0, color_mode=0)
    img0 = e2.render_frame(cam, pv0, width=64, height=64)
    assert e2._identity_dirty         # col24 made mode 0 sort-free too
    e3 = _engine(False)
    for _ in range(1):
        e3.step(pv_vel)
    img0_ref = e3.render_frame(cam, pv0, width=64, height=64)
    assert abs(img0.astype(int) - img0_ref.astype(int)).max() <= 3
