"""PM solver integration: Engine, multi-device psum-grid step, checkpoint,
CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import particle_sim_tpu as psim
from particle_sim_tpu.core.params import Method, PairwiseParams, PMConfig
from particle_sim_tpu.engine import Engine

CFG = PMConfig(softening=4.0)


@pytest.mark.slow
def test_engine_pm_collapses_cloud():
    e = Engine(particle_count=4096, method=Method.JNP,
               generation_mode=psim.SphereGeneration.FILLED,
               pairwise=PairwiseParams(2.0, CFG.softening), pm=CFG)
    params = psim.SimParams(delta_time=0.02)
    r0 = np.linalg.norm(e.state.positions(), axis=1).mean()
    for _ in range(15):
        e.step(params)
    r1 = np.linalg.norm(e.state.positions(), axis=1).mean()
    assert np.isfinite(r1) and r1 < r0


def test_engine_pm_defaults_pairwise():
    e = Engine(particle_count=1024, method=Method.JNP, pm=CFG)
    assert e.pairwise is not None
    assert e.pairwise.softening == CFG.softening


@pytest.mark.slow
def test_mesh_pm_matches_single_device():
    """psum-grid sharded PM step == single-device reference step."""
    from particle_sim_tpu.parallel import mesh as mesh_lib, pm_dp
    from particle_sim_tpu.ops import pm

    n_dev = len(jax.devices())
    assert n_dev >= 2, "conftest forces an 8-device CPU mesh"
    mesh = mesh_lib.make_mesh()
    n = n_dev * 8 * 128 * 2
    pos, vel, col = psim.generate.generate(n, psim.SphereGeneration.FILLED)
    n_act = n - 137  # exercise cross-shard active-count translation
    st = psim.ParticleState.from_arrays(pos, vel, col,
                                        row_multiple=8 * n_dev)
    st = psim.ParticleState(pos=st.pos, vel=st.vel, init_color=st.init_color,
                            n_active=jnp.asarray(n_act, jnp.int32))
    pv = jnp.asarray(psim.SimParams(delta_time=0.016, gravity=0.3).pack())
    pp = jnp.asarray(PairwiseParams(1.5, CFG.softening).pack())

    pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, st.pos, st.vel)
    step = pm_dp.make_pm_step(mesh, CFG)
    p_mesh, v_mesh = step(pos_sh, vel_sh, pv, pp, st.n_active)

    p_ref, v_ref = pm.step_pm_ref(jnp.array(st.pos), jnp.array(st.vel),
                                  pv, pp, st.n_active, CFG)
    # Compare the active region only: the solvers agree to float noise
    # there (psum changes deposit accumulation order, so not bitwise);
    # padding differs by design — the sharded step zeroes its
    # acceleration while the single-device reference harmlessly steps it
    # (both are masked by every consumer).
    def active(x):
        return np.asarray(x).reshape(3, -1)[:, :n_act]

    np.testing.assert_allclose(active(p_mesh), active(p_ref), atol=1e-2)
    np.testing.assert_allclose(active(v_mesh), active(v_ref), atol=1e-2)


@pytest.mark.slow
def test_engine_mesh_pm_steps():
    from particle_sim_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh()
    e = Engine(particle_count=mesh.devices.size * 1024, method=Method.JNP,
               pm=CFG, mesh=mesh)
    e.step(psim.SimParams(delta_time=0.016))
    assert np.isfinite(e.state.positions()).all()


def test_checkpoint_roundtrip_pm(tmp_path):
    from particle_sim_tpu.io import checkpoint as ckpt

    e = Engine(particle_count=777, method=Method.JNP,
               pm=PMConfig(softening=3.0, boundary="periodic",
                           gradient="fd"))
    e.step(psim.SimParams())
    path = str(tmp_path / "pm.npz")
    ckpt.save(path, e, step_index=5)
    e2, step = ckpt.load(path)
    assert step == 5
    assert e2.pm == e.pm
    np.testing.assert_allclose(e2.state.positions(), e.state.positions(),
                               atol=1e-6)
    e2.step(psim.SimParams())  # resumed engine steps with the pm solver


def test_cli_pm_run(tmp_path, capsys):
    from particle_sim_tpu.app import cli

    rc = cli.main([
        "--count", "2000", "--steps", "3", "--method", "jnp",
        "--pm", "--pairwise-g", "1.0", "--pairwise-softening", "4.0",
        "--stats-every", "0",
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    final = json.loads(out[-1])
    assert final["done"] is True


@pytest.mark.slow
def test_mesh_pm_auto_box_matches_single_device():
    """Global traced box (pmin/pmax) == single-device auto-box solve."""
    from particle_sim_tpu.parallel import mesh as mesh_lib, pm_dp
    from particle_sim_tpu.ops import pm

    mesh = mesh_lib.make_mesh()
    n_dev = mesh.devices.size
    n = n_dev * 8 * 128
    rng = np.random.default_rng(8)
    pos = (rng.normal(size=(n, 3)) * 5.0
           + np.float32([20, -15, 30])).astype(np.float32)
    st = psim.ParticleState.from_arrays(pos, np.zeros_like(pos),
                                        np.zeros_like(pos),
                                        row_multiple=8 * n_dev)
    cfg = PMConfig(softening=6.0, auto_box=True)
    pv = jnp.asarray(psim.SimParams(delta_time=0.016).pack())
    pp = jnp.asarray(PairwiseParams(1.0, cfg.softening).pack())
    pos_sh, vel_sh = mesh_lib.shard_state_planes(mesh, st.pos, st.vel)
    step = pm_dp.make_pm_step(mesh, cfg)
    p_mesh, v_mesh = step(pos_sh, vel_sh, pv, pp, st.n_active)
    p_ref, v_ref = pm.step_pm_ref(jnp.array(st.pos), jnp.array(st.vel),
                                  pv, pp, st.n_active, cfg)

    def active(x):
        return np.asarray(x).reshape(3, -1)[:, :n]

    np.testing.assert_allclose(active(p_mesh), active(p_ref), atol=1e-2)
    np.testing.assert_allclose(active(v_mesh), active(v_ref), atol=1e-2)
