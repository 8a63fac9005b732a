"""Multi-device Engine mode on the virtual 8-device mesh."""

import numpy as np
import pytest

import jax

from particle_sim_tpu.core.params import (
    Method, PairwiseParams, SimParams, SphereGeneration,
)
from particle_sim_tpu.engine import Engine
from particle_sim_tpu.parallel import mesh as mesh_lib

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device platform")


def engines(n=4096, **kw):
    single = Engine(particle_count=n, method=Method.JNP, **kw)
    sharded = Engine(particle_count=n, method=Method.JNP,
                     mesh=mesh_lib.make_mesh(), **kw)
    return single, sharded


def test_sharded_step_matches_single(n=4096):
    single, sharded = engines(n)
    params = SimParams(gravity=1.5, is_mouse_dragging=True,
                       mouse_position=(2, -3, 10), mouse_force=40.0)
    for _ in range(4):
        single.step(params)
        sharded.step(params)
    np.testing.assert_allclose(sharded.state.positions(),
                               single.state.positions(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sharded.state.velocities(),
                               single.state.velocities(), rtol=0, atol=1e-5)


def test_sharded_state_is_sharded():
    _, sharded = engines()
    sh = sharded.state.pos.sharding
    assert sh == mesh_lib.plane_sharding(mesh_lib.make_mesh())


def test_sharded_pairwise_ring():
    pw = PairwiseParams(2.0, 0.5)
    single, sharded = engines(2048, pairwise=pw)
    params = SimParams()
    for _ in range(3):
        single.step(params)
        sharded.step(params)
    np.testing.assert_allclose(sharded.state.positions(),
                               single.state.positions(), rtol=1e-4, atol=1e-4)


def test_sharded_lifecycle():
    _, sharded = engines(3000)
    sharded.step(SimParams(gravity=2.0))
    evolved = sharded.state.positions()
    sharded.resize(5000)
    assert sharded.particle_count == 5000
    np.testing.assert_allclose(sharded.state.positions()[:3000], evolved,
                               atol=1e-6)
    assert sharded.state.pos.sharding == mesh_lib.plane_sharding(
        mesh_lib.make_mesh())
    sharded.resize(1000)
    assert sharded.particle_count == 1000
    sharded.reset()
    assert (sharded.state.velocities() == 0).all()


def test_cli_mesh_auto(tmp_path, capsys):
    import json

    from particle_sim_tpu.app.cli import main
    rc = main(["--count", "2000", "--steps", "10", "--method", "jnp",
               "--mesh", "auto", "--gravity", "1.0", "--stats-every", "0"])
    assert rc == 0
    out = capsys.readouterr()
    final = json.loads(out.out.strip().splitlines()[-1])
    assert final["done"]
    assert "mesh: dp over 8 devices" in out.err


def test_mesh_render_and_stream():
    """Output paths consume sharded state (XLA inserts the gathers)."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import Method
    from particle_sim_tpu.engine import Engine
    from particle_sim_tpu.parallel import mesh as mesh_lib
    from particle_sim_tpu.render.camera import Camera

    mesh = mesh_lib.make_mesh()
    e = Engine(particle_count=mesh.devices.size * 1024, method=Method.JNP,
               mesh=mesh)
    p = psim.SimParams(color_mode=1, gravity=1.0)
    e.step(p)
    img = e.render_frame(Camera(aspect=16 / 9), p, width=1280, height=720)
    assert img.shape == (720, 1280, 4) and (img[..., :3] > 0).any()
    pos, rgba = e.frame_arrays(p, max_points=500)
    assert pos.shape[0] == 3 and rgba.shape[1] == 4


def test_mesh_render_psum_composite():
    """Multi-device rendering: each shard rasterizes its rows and ONE
    framebuffer psum composites (parallel/render_dp.py) — no particle
    gather. Must match the single-device render within the additive
    blend's summation-order tolerance."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.render.camera import Camera

    mesh = mesh_lib.make_mesh()
    n = mesh.devices.size * 1024
    single = Engine(particle_count=n, method=Method.JNP)
    sharded = Engine(particle_count=n, method=Method.JNP, mesh=mesh)
    p = psim.SimParams(color_mode=1, gravity=1.0)
    for _ in range(2):
        single.step(p)
        sharded.step(p)
    cam = Camera(aspect=2.0)
    img_s = sharded.render_frame(cam, p, width=256, height=128)
    img_1 = single.render_frame(cam, p, width=256, height=128)
    assert (img_s[..., :3] > 0).any()
    assert abs(img_s.astype(int) - img_1.astype(int)).max() <= 2


@pytest.mark.slow
def test_mesh_persist_render_from_carry():
    """Persist + mesh: the frame renders from the SHARDED sorted carry
    (positions + carried col24) without rebuilding identity order, and
    matches the render of the rebuilt identity-order planes."""
    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import PMConfig
    from particle_sim_tpu.render.camera import Camera

    mesh = mesh_lib.make_mesh()
    n = mesh.devices.size * 1024
    cfg = PMConfig(softening=4.0)
    e = Engine(particle_count=n, method=Method.PALLAS, interpret=True,
               pm=cfg, pm_persist=True, mesh=mesh)
    p = psim.SimParams(color_mode=0, gravity=0.0, delta_time=0.016)
    for _ in range(2):
        e.step(p)
    assert e._identity_dirty
    cam = Camera(aspect=2.0)
    img = e.render_frame(cam, p, width=256, height=128)
    assert e._identity_dirty            # no identity rebuild was paid
    e.ensure_identity_order()
    img_ref = e.render_frame(cam, p, width=256, height=128)
    assert not e._identity_dirty
    assert (img[..., :3] > 0).any()
    assert abs(img.astype(int) - img_ref.astype(int)).max() <= 3
