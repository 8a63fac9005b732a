"""Headless point-sprite rasterizer — the render-pipeline analog.

Replicates the semantics of the reference's wgpu point-list pipeline
(``/root/reference/src/renderer.rs:74-90`` + ``src/shaders/particle.wgsl``):

  * vertex: ``clip = view_proj @ [pos, 1]`` (particle.wgsl:29)
  * fragment: ``rgb * min(2|v|, 1)`` brightness, source alpha kept
    (particle.wgsl:41-44)
  * one pixel per particle (PointList topology, renderer.rs:82)
  * no depth buffer (renderer.rs:90, main.rs:67)

Deviation (documented spec decision): the reference uses non-premultiplied
ALPHA_BLENDING whose result depends on draw order, which is *undefined* for
unsorted points without depth — i.e. the reference's own image is
nondeterministic. We define the blend as commutative premultiplied additive
accumulation clamped to 1: order-independent (up to the order of float
additions, which atomic adds do not fix) and a plain scatter-add, so it
parallelizes without a sort and composes across devices by summation. Colors
are computed on the fly from (pos, vel, init_color, params) via the shared
color module (see core/state.py for why color is not stored).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core import params as P
from ..ops import physics


def project_to_pixels(
    pos_flat: jax.Array,        # f32[3, N]
    view_proj: jax.Array,       # f32[4, 4]
    width: int, height: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """-> (px i32[N], py i32[N], valid f32[N]). Traceable.

    Clip test matches the hardware pipeline: -w<=x,y<=w, 0<=z<=w, w>0.
    """
    x, y, z = pos_flat[0], pos_flat[1], pos_flat[2]
    cx = view_proj[0, 0] * x + view_proj[0, 1] * y + view_proj[0, 2] * z + view_proj[0, 3]
    cy = view_proj[1, 0] * x + view_proj[1, 1] * y + view_proj[1, 2] * z + view_proj[1, 3]
    cz = view_proj[2, 0] * x + view_proj[2, 1] * y + view_proj[2, 2] * z + view_proj[2, 3]
    cw = view_proj[3, 0] * x + view_proj[3, 1] * y + view_proj[3, 2] * z + view_proj[3, 3]

    w_ok = cw > 1e-8
    inv_w = jnp.where(w_ok, 1.0 / jnp.maximum(cw, 1e-8), 0.0)
    ndc_x = cx * inv_w
    ndc_y = cy * inv_w
    ndc_z = cz * inv_w
    valid = (
        w_ok
        & (jnp.abs(ndc_x) <= 1.0)
        & (jnp.abs(ndc_y) <= 1.0)
        & (ndc_z >= 0.0) & (ndc_z <= 1.0)
    )
    px = jnp.clip(((ndc_x + 1.0) * 0.5 * width).astype(jnp.int32), 0, width - 1)
    py = jnp.clip(((1.0 - ndc_y) * 0.5 * height).astype(jnp.int32), 0, height - 1)
    return px, py, valid.astype(jnp.float32)


def shaded_rgb(flat_pos, flat_vel, flat_col, param_vec):
    """Shared coloring contract of every consumer: per-point RGB by color
    mode plus the fragment brightness min(2|v|,1) (particle.wgsl:41-44).
    One implementation so the rasterized frame and the streamed wire
    colors can never drift apart. -> (r, g, b, bright), each f32[N]."""
    r, g, b = physics.color_rgb(
        flat_pos[0], flat_pos[1], flat_pos[2],
        flat_vel[0], flat_vel[1], flat_vel[2],
        flat_col[0], flat_col[1], flat_col[2],
        color_mode=param_vec[P.P_COLOR_MODE],
        max_dist_for_color=param_vec[P.P_MAX_DIST],
    )
    bright = physics.brightness(flat_vel[0], flat_vel[1], flat_vel[2])
    return r, g, b, bright


def render(
    pos: jax.Array,          # f32[3, R, LANE]
    vel: jax.Array,
    init_color: jax.Array,
    param_vec: jax.Array,
    view_proj: jax.Array,    # f32[4, 4]
    n_active: jax.Array,     # i32
    *,
    width: int = 1920,
    height: int = 1080,
    background: float = 0.0,
    clip: bool = True,
) -> jax.Array:
    """f32[height, width, 3] framebuffer in [0, 1]. Traceable. Planes may
    be (3, R, LANE) or flat (3, N). ``clip=False`` leaves the sum
    unclipped, for partial framebuffers that are summed across devices
    before the clip (parallel/render_dp.py)."""
    flat_pos = pos.reshape(3, -1)
    flat_vel = vel.reshape(3, -1)
    flat_col = init_color.reshape(3, -1)
    n = flat_pos.shape[1]

    r, g, b, bright = shaded_rgb(flat_pos, flat_vel, flat_col, param_vec)

    px, py, valid = project_to_pixels(flat_pos, view_proj, width, height)
    active = (jnp.arange(n, dtype=jnp.int32) < n_active).astype(jnp.float32)
    weight = valid * active  # alpha is 1.0 throughout the reference

    rgb = jnp.stack([r, g, b], axis=1) * (bright * weight)[:, None]  # [N, 3]
    fb = jnp.full((height, width, 3), background, dtype=jnp.float32)
    fb = fb.at[py, px].add(rgb, mode="drop")
    return jnp.clip(fb, 0.0, 1.0) if clip else fb


@functools.partial(jax.jit, static_argnames=("width", "height"))
def render_jit(pos, vel, init_color, param_vec, view_proj, n_active,
               width: int = 1920, height: int = 1080):
    return render(pos, vel, init_color, param_vec, view_proj, n_active,
                  width=width, height=height)


@functools.partial(jax.jit, static_argnames=("stride",))
def _pack_points(pos, vel, init_color, param_vec, n_stop, stride: int = 1):
    flat_pos = pos.reshape(3, -1)[:, ::stride]
    flat_vel = vel.reshape(3, -1)[:, ::stride]
    flat_col = init_color.reshape(3, -1)[:, ::stride]
    n = flat_pos.shape[1]
    r, g, b, bright = shaded_rgb(flat_pos, flat_vel, flat_col, param_vec)
    active = ((jnp.arange(n, dtype=jnp.int32) * stride) < n_stop)
    af = active.astype(jnp.float32)
    rgb = jnp.stack([r, g, b]) * (bright * af)
    rgba = jnp.concatenate(
        [rgb, af[None, :]], axis=0).T                       # [n, 4]
    rgba8 = (jnp.clip(rgba, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    return flat_pos, rgba8


def pack_points_jit(pos, vel, init_color, param_vec, n_stop, stride: int = 1):
    """Device-side stream packing: -> (pos f32[3, m], rgba8 u8[m, 4]).

    Inactive slots get alpha 0 (clients discard); stride subsamples on
    device so only the subsample crosses to the host.
    """
    return _pack_points(pos, vel, init_color, param_vec,
                        jnp.asarray(n_stop, jnp.int32), stride=stride)


def pack_col24(col_flat: jax.Array) -> jax.Array:
    """f32[3, N] in [0,1] -> i32[N] 8:8:8-packed display color — the
    codec for pm_persist.SortedPMState.col24 (u8 per channel matches the
    wire format's rgba8 quantization, io/packer.py)."""
    c8 = (jnp.clip(col_flat, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.int32)
    return c8[0] | (c8[1] << 8) | (c8[2] << 16)


def unpack_col24(col24: jax.Array) -> jax.Array:
    """i32[N] packed display color -> f32[3, N] in [0,1]."""
    return jnp.stack([((col24 >> s) & 0xFF)
                      for s in (0, 8, 16)]).astype(jnp.float32) / 255.0


def to_rgba8(fb: jax.Array) -> jax.Array:
    """f32[H,W,3] -> u8[H,W,4] (alpha 255)."""
    rgb8 = (jnp.clip(fb, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    alpha = jnp.full(fb.shape[:2] + (1,), 255, dtype=jnp.uint8)
    return jnp.concatenate([rgb8, alpha], axis=-1)
