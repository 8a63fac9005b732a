"""Headless rasterizer: projection correctness, blending, golden frame."""

import numpy as np
import pytest

import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import ColorMode, SimParams
from particle_sim_tpu.core.state import ParticleState
from particle_sim_tpu.render import raster
from particle_sim_tpu.render.camera import Camera

W, H = 160, 120


def make_state(n=1000, mode=G.SphereGeneration.HOLLOW):
    pos, vel, col = G.generate(n, mode)
    return ParticleState.from_arrays(pos, vel, col)


def fb_for(state, params=None, cam=None, w=W, h=H):
    params = params or SimParams()
    cam = cam or Camera(aspect=w / h)
    return np.asarray(raster.render(
        state.pos, state.vel, state.init_color, jnp.asarray(params.pack()),
        jnp.asarray(cam.view_proj()), state.n_active, width=w, height=h,
    ))


class TestProjection:
    def test_single_particle_center_pixel(self):
        pos = np.array([[0.0, 0.0, 0.0]], np.float32)
        state = ParticleState.from_arrays(
            pos, np.zeros_like(pos) + np.array([[3.0, 0, 0]], np.float32),
            np.ones((1, 3), np.float32))
        fb = fb_for(state)
        ys, xs = np.nonzero(fb.sum(-1))
        assert list(zip(ys, xs)) == [(H // 2, W // 2)]

    def test_behind_camera_culled(self):
        pos = np.array([[0.0, 0.0, 200.0]], np.float32)  # behind (cam at z=100)
        vel = np.full((1, 3), 5.0, np.float32)
        state = ParticleState.from_arrays(pos, vel, np.ones((1, 3), np.float32))
        assert fb_for(state).sum() == 0.0

    def test_brightness_is_velocity_scaled(self):
        # |v|=0.25 -> brightness 0.5 (particle.wgsl:41-42: min(2|v|,1))
        pos = np.array([[0.0, 0.0, 0.0]], np.float32)
        vel = np.array([[0.25, 0.0, 0.0]], np.float32)
        state = ParticleState.from_arrays(pos, vel, np.ones((1, 3), np.float32))
        fb = fb_for(state)
        assert fb[H // 2, W // 2] == pytest.approx([0.5] * 3, abs=1e-6)

    def test_padding_not_rendered(self):
        # padded slots sit at (0,0,0) which projects on-screen: must not glow
        pos = np.array([[20.0, 0.0, 0.0]], np.float32)
        vel = np.full((1, 3), 5.0, np.float32)
        state = ParticleState.from_arrays(pos, vel, np.ones((1, 3), np.float32))
        fb = fb_for(state)
        assert fb[H // 2, W // 2].sum() == 0.0  # origin pixel dark
        assert fb.sum() > 0                      # the real particle rendered

    def test_additive_blend_clamps(self):
        # two coincident particles: contributions add then clamp to 1
        pos = np.zeros((2, 3), np.float32)
        vel = np.full((2, 3), 5.0, np.float32)
        col = np.full((2, 3), 0.4, np.float32)
        state = ParticleState.from_arrays(pos, vel, col)
        fb = fb_for(state)
        assert fb[H // 2, W // 2] == pytest.approx([0.8] * 3, abs=1e-5)


class TestColorModes:
    def test_position_mode_colors(self):
        state = make_state(2000)
        fb0 = fb_for(state, SimParams(color_mode=int(ColorMode.ORIGINAL)))
        fb2 = fb_for(state, SimParams(color_mode=int(ColorMode.POSITION)))
        assert fb0.sum() == 0.0  # velocity 0 -> brightness 0 everywhere
        assert fb2.sum() == 0.0
        # give them speed: both modes now differ
        v = np.full((2000, 3), 2.0, np.float32)
        pos, _, col = G.generate(2000)
        state = ParticleState.from_arrays(pos, v, col)
        fb0 = fb_for(state, SimParams(color_mode=int(ColorMode.ORIGINAL)))
        fb2 = fb_for(state, SimParams(color_mode=int(ColorMode.POSITION)))
        assert fb0.sum() > 0 and fb2.sum() > 0
        assert not np.allclose(fb0, fb2)


class TestGoldenFrame:
    def test_fixed_scene_reproducible(self):
        # Filled sphere is seed-fixed (mod.rs:170) -> frame is deterministic.
        pos, _, col = G.generate(5000, G.SphereGeneration.FILLED)
        vel = np.tile(np.array([[0.0, 0.5, 0.0]], np.float32), (5000, 1))
        state = ParticleState.from_arrays(pos, vel, col)
        fb1 = fb_for(state, SimParams(color_mode=2))
        fb2 = fb_for(state, SimParams(color_mode=2))
        np.testing.assert_array_equal(fb1, fb2)
        assert 0.001 < fb1.mean() < 0.9  # scene visible, not washed out

    def test_rgba8_roundtrip(self):
        state = make_state(500)
        fb = raster.render(
            state.pos, state.vel, state.init_color,
            jnp.asarray(SimParams().pack()),
            jnp.asarray(Camera(aspect=W / H).view_proj()),
            state.n_active, width=W, height=H)
        img = np.asarray(raster.to_rgba8(fb))
        assert img.shape == (H, W, 4) and img.dtype == np.uint8
        assert (img[..., 3] == 255).all()


def test_png_writer(tmp_path):
    from particle_sim_tpu.utils.png import write_png
    img = (np.random.default_rng(0).random((10, 12, 3)) * 255).astype(np.uint8)
    path = tmp_path / "t.png"
    write_png(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IEND" in data


# --------------------------------------------------------------------------
# raster.render against an independent numpy transcription of the pipeline
# (projection + clip test + additive blend), over sizes, color modes,
# partial occupancy, culling and resolutions of any shape
# --------------------------------------------------------------------------

def _random_args(n, color_mode=1, seed=0, spread=40.0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.random((n, 3)).astype(np.float32)
    return ParticleState.from_arrays(pos, vel, col), SimParams(
        color_mode=color_mode)


def _numpy_render(state, params, cam, w, h):
    from particle_sim_tpu.ops import step_jnp

    n = int(state.n_active)
    p = state.positions().astype(np.float32)
    v = state.velocities().astype(np.float32)
    rgb = np.asarray(step_jnp.colors(
        state.pos, state.vel, state.init_color,
        jnp.asarray(params.pack()))).reshape(3, -1)[:, :n].T
    vp = np.asarray(cam.view_proj(), np.float32)
    clip = np.concatenate([p, np.ones((n, 1), np.float32)], 1) @ vp.T
    cw = clip[:, 3]
    ok = cw > 1e-8
    ndc = clip[:, :3] / np.where(ok, cw, 1.0)[:, None]
    ok &= (np.abs(ndc[:, 0]) <= 1) & (np.abs(ndc[:, 1]) <= 1)
    ok &= (ndc[:, 2] >= 0) & (ndc[:, 2] <= 1)
    px = np.clip(((ndc[:, 0] + 1) * 0.5 * w).astype(np.int64), 0, w - 1)
    py = np.clip(((1 - ndc[:, 1]) * 0.5 * h).astype(np.int64), 0, h - 1)
    bright = np.minimum(2.0 * np.linalg.norm(v, axis=1), 1.0)
    fb = np.zeros((h, w, 3), np.float64)
    np.add.at(fb, (py[ok], px[ok]), (rgb * bright[:, None])[ok])
    return np.clip(fb, 0.0, 1.0)


@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_matches_numpy_pipeline(n, mode):
    state, params = _random_args(n, mode, seed=n + mode)
    cam = Camera(aspect=W / H)
    got = fb_for(state, params, cam)
    want = _numpy_render(state, params, cam, W, H)
    assert want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_partial_occupancy_masked(n=900):
    # capacity 1024: the 124 padding slots must contribute nothing
    state, params = _random_args(n, 1, seed=3)
    assert state.capacity > n
    cam = Camera(aspect=W / H)
    np.testing.assert_allclose(fb_for(state, params, cam),
                               _numpy_render(state, params, cam, W, H),
                               rtol=0, atol=1e-5)


def test_order_independence():
    # the additive blend is commutative: any permutation of the points
    # renders the same frame (up to float summation order)
    state, params = _random_args(3000, 1, seed=4, spread=10.0)
    perm = np.random.default_rng(5).permutation(3000)
    shuffled = ParticleState.from_arrays(
        state.positions()[perm], state.velocities()[perm],
        state.init_colors_rgba()[perm, :3])
    np.testing.assert_allclose(fb_for(shuffled, params), fb_for(state, params),
                               rtol=0, atol=1e-5)


def test_offscreen_cloud_is_black():
    # a cloud entirely outside the frustum (far to the side) draws nothing
    state, params = _random_args(2000, 1, seed=6, spread=1.0)
    far = ParticleState.from_arrays(
        state.positions() + np.float32([1e4, 0.0, 0.0]),
        state.velocities(), state.init_colors_rgba()[:, :3])
    assert fb_for(far, params).sum() == 0.0


def test_hotspot_single_pixel():
    # 4096 coincident dim points land on ONE pixel: their contributions
    # accumulate (no lost updates) and clamp only at the end
    n = 4096
    pos = np.zeros((n, 3), np.float32)
    vel = np.full((n, 3), 5.0, np.float32)
    col = np.full((n, 3), 1e-4, np.float32)
    state = ParticleState.from_arrays(pos, vel, col)
    fb = np.asarray(raster.render(
        state.pos, state.vel, state.init_color,
        jnp.asarray(SimParams().pack()),
        jnp.asarray(Camera(aspect=W / H).view_proj()), state.n_active,
        width=W, height=H, clip=False))
    assert fb[H // 2, W // 2] == pytest.approx([n * 1e-4] * 3, rel=1e-4)
    assert np.count_nonzero(fb.sum(-1)) == 1


@pytest.mark.parametrize("w,h", [(100, 37), (1281, 721)])
def test_any_resolution(w, h):
    # no tile alignment: every width/height renders, and matches numpy
    state, params = _random_args(2000, 2, seed=w)
    cam = Camera(aspect=w / h)
    got = fb_for(state, params, cam, w=w, h=h)
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, _numpy_render(state, params, cam, w, h),
                               rtol=0, atol=1e-5)


def test_parity_check_small():
    # the chip_smoke raster parity function, at a CPU-sized width
    from particle_sim_tpu.utils import parity
    r = parity.raster(16384, width=320, height=180)
    assert r["ok"] and r["lit_pixels"] > 0, r


@pytest.mark.gpu
def test_parity_on_card():
    from particle_sim_tpu.utils import parity
    r = parity.raster(1_000_000)
    assert r["ok"], r
