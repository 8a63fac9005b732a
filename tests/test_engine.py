"""Engine lifecycle semantics vs the reference's app/trait behavior."""

import numpy as np
import pytest

from particle_sim_tpu.core.params import (
    Method, PairwiseParams, SimParams, SphereGeneration,
)
from particle_sim_tpu.engine import Engine, available_methods


def make_engine(n=2000, **kw):
    kw.setdefault("method", Method.JNP)
    return Engine(particle_count=n, **kw)


class TestCapability:
    def test_jnp_always_available(self):
        assert Method.JNP in available_methods()

    def test_default_counts(self):
        # app.rs:108/117: CPU default 100k, compute default 1M
        e = Engine(method=Method.JNP)
        assert e.particle_count == 100_000


class TestPause:
    def test_pause_gates_stepping(self):
        e = make_engine()
        p0 = e.state.pos
        e.set_paused(True)
        e.step(SimParams(gravity=5.0))
        assert e.state.pos is p0          # untouched (app.rs:283)
        e.set_paused(False)
        e.step(SimParams(gravity=5.0))
        assert e.state.pos is not p0


class TestReset:
    def test_reset_regenerates(self):
        e = make_engine()
        before = e.state.positions()
        for _ in range(3):
            e.step(SimParams(gravity=3.0))
        moved = e.state.positions()
        assert not np.allclose(before, moved)
        e.reset()
        np.testing.assert_allclose(e.state.positions(), before, atol=1e-5)

    def test_filled_reset_bit_identical(self):
        # fixed seed 69 (mod.rs:170)
        e = make_engine(generation_mode=SphereGeneration.FILLED)
        a = e.state.positions().copy()
        e.step(SimParams(gravity=1.0))
        e.reset()
        np.testing.assert_array_equal(e.state.positions(), a)


class TestResize:
    def test_shrink_keeps_capacity_and_state(self):
        e = make_engine(n=3000)
        cap = e.capacity
        head = e.state.positions()[:500]
        e.resize(500)
        assert e.particle_count == 500
        assert e.capacity == cap                      # cpu.rs:132-150
        np.testing.assert_array_equal(e.state.positions(), head)

    def test_grow_appends_preserving_state(self):
        e = make_engine(n=1000)
        e.step(SimParams(gravity=2.0, delta_time=0.1))
        evolved = e.state.positions()
        e.resize(2500)
        assert e.particle_count == 2500
        # first 1000 keep their evolved positions (cpu.rs:136-147)
        np.testing.assert_array_equal(e.state.positions()[:1000], evolved)
        # appended 1500 are freshly generated (velocity zero)
        assert (e.state.velocities()[1000:] == 0).all()

    def test_resize_to_one_clamped(self):
        e = make_engine(n=100)
        e.resize(0)  # app.rs:480: max(1)
        assert e.particle_count == 1

    def test_generation_mode_change_regenerates(self):
        e = make_engine(n=1000)
        e.step(SimParams(gravity=2.0))
        e.resize(1000, generation_mode=SphereGeneration.FILLED)
        assert e.generation_mode == SphereGeneration.FILLED
        assert (e.state.velocities() == 0).all()      # fresh state


class TestMethodSwitch:
    def test_switch_preserves_count_and_pause(self):
        if Method.PALLAS not in available_methods(True):
            pytest.skip("no pallas")
        e = Engine(particle_count=1500, method=Method.JNP, interpret=True)
        e.set_paused(True)
        e.step(SimParams())
        e.set_method(Method.PALLAS)
        assert e.particle_count == 1500               # app.rs:178,199
        assert e.is_paused()                          # app.rs:179,197
        # state regenerated, not migrated (app.rs:182-195)
        assert (e.state.velocities() == 0).all()

    def test_unavailable_method_raises(self):
        e = make_engine()
        import jax
        if jax.default_backend() != "gpu":
            with pytest.raises(ValueError):
                e.set_method(Method.PALLAS)


class TestStepping:
    def test_trajectory_matches_plain_stepper(self):
        import jax.numpy as jnp
        from particle_sim_tpu.ops import step_jnp
        e = make_engine(n=800)
        pv = SimParams(gravity=1.5, is_mouse_dragging=True,
                       mouse_position=(0, 0, 10), mouse_force=30.0)
        # engine steps DONATE the state buffers — copy before aliasing
        ep, ev = jnp.array(e.state.pos), jnp.array(e.state.vel)
        for _ in range(5):
            e.step(pv)
            ep, ev = step_jnp.step(ep, ev, jnp.asarray(pv.pack()))
        np.testing.assert_allclose(np.asarray(e.state.pos), np.asarray(ep),
                                   rtol=1e-6, atol=1e-6)

    def test_pairwise_mode(self):
        e = make_engine(n=512, pairwise=PairwiseParams(2.0, 0.5))
        r0 = np.linalg.norm(e.state.positions(), axis=1).mean()
        for _ in range(20):
            e.step(SimParams())
        r1 = np.linalg.norm(e.state.positions(), axis=1).mean()
        assert r1 < r0  # mutual gravity pulls the cloud inward

    def test_no_recompile_on_param_changes(self):
        # headline design decision: every interactive control is a traced
        # scalar — parameter edits (sliders, mouse, color mode) must never
        # retrace (SURVEY.md §7 "interactive loop latency")
        from particle_sim_tpu.ops import step_jnp
        e = make_engine(n=512)
        e.step(SimParams(gravity=1.0))
        size0 = step_jnp.step_n_jit._cache_size()
        for p in [
            SimParams(gravity=4.2),
            SimParams(mouse_force=99.0, mouse_radius=3.0),
            SimParams(is_mouse_dragging=True, mouse_position=(9, 9, 9)),
            SimParams(color_mode=2, max_dist_for_color=10.0),
            SimParams(delta_time=0.004, damping=0.5),
        ]:
            e.step(p)
        assert step_jnp.step_n_jit._cache_size() == size0

    def test_stats_update(self):
        e = make_engine()
        e.step_synced(SimParams())
        snap = e.stats.snapshot()
        assert snap["steps_total"] == 2  # step + synced record
        assert snap["device_ms"] > 0


class TestOutput:
    def test_colors_rgba(self):
        e = make_engine(n=300)
        c = e.colors_rgba(SimParams())
        assert c.shape == (300, 4)
        assert (c[:, 3] == 1.0).all()
        np.testing.assert_allclose(c[:, :3], e.state.init_colors_rgba()[:, :3])

    def test_render_frame(self):
        e = make_engine(n=2000)
        from particle_sim_tpu.render.camera import Camera
        for _ in range(2):
            e.step(SimParams(gravity=2.0, delta_time=0.05))
        img = e.render_frame(Camera(aspect=4 / 3), SimParams(color_mode=2),
                             width=160, height=120)
        assert img.shape == (120, 160, 4) and img.dtype == np.uint8
        assert img[..., :3].sum() > 0


def test_zeros_state_planes_are_independent():
    """Regression: zeros_state once aliased ONE buffer as pos/vel/color;
    a donating step then deleted init_color out from under later use."""
    import jax.numpy as jnp

    from particle_sim_tpu.core.state import zeros_state
    from particle_sim_tpu.ops import step_jnp

    st = zeros_state(1024)
    assert st.capacity == 1024  # and never silently truncates
    assert zeros_state(1000).capacity >= 1000
    from particle_sim_tpu.core.params import SimParams
    pv = jnp.asarray(SimParams().pack())
    p, v = step_jnp.step_n_jit(st.pos, st.vel, pv, 1)  # donates pos/vel
    colors = np.asarray(st.init_color)  # must still be alive
    assert colors.shape[0] == 3
