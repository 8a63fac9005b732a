"""Fused attractor stepper — a Pallas kernel on the Triton route.

The reference's GPU path dispatches a 256-lane WGSL kernel per frame doing
force + integrate + color per particle (``/root/reference/src/shaders/
compute.wgsl:31-99``). This is its counterpart here: one Pallas program per
``BLOCK`` particles of the flattened SoA planes, each loading the packed
parameter vector itself, outputs aliased onto inputs (the persistent
STORAGE-buffer analog of ``compute.rs:28-34``).

Beyond-reference capability: ``substeps`` runs K physics steps per
device-memory round trip *inside* the kernel. The attractor workload is
per-particle independent, so a block's six state values stay in registers
for all K steps — the HBM cost (48 B/particle read + write) is paid once per
launch instead of once per step, which an XLA ``fori_loop`` over
``step_jnp.step`` cannot do. (Interactive mode uses substeps=1: params
change every frame, app.rs:290-307.)

Color is intentionally NOT written per step (see core/state.py) — the packer
and rasterizer fuse ``physics.color_rgb`` at consumption time.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import params as P
from . import physics

BLOCK = 1024       # particles per program (power of two, Triton tensor size)
NUM_WARPS = 4


def _kernel(pv_ref, pos_ref, vel_ref, opos_ref, ovel_ref, *, n, substeps):
    off = pl.program_id(0) * BLOCK
    idx = off + jnp.arange(BLOCK, dtype=jnp.int32)
    mask = idx < n
    cols = pl.ds(off, BLOCK)
    s = lambda i: pv_ref[i]
    kw = dict(
        dt=s(P.P_DT), gravity=s(P.P_GRAVITY),
        mouse_force=s(P.P_MOUSE_FORCE), mouse_radius=s(P.P_MOUSE_RADIUS),
        damping=s(P.P_DAMPING),
        mouse_x=s(P.P_MOUSE_X), mouse_y=s(P.P_MOUSE_Y), mouse_z=s(P.P_MOUSE_Z),
        dragging=s(P.P_DRAGGING),
    )
    state = tuple(
        plgpu.load(ref.at[c, cols], mask=mask, other=0.0)
        for ref in (pos_ref, vel_ref) for c in range(3))

    def body(_, st):
        return physics.attractor_step(*st, **kw)

    state = jax.lax.fori_loop(0, substeps, body, state)
    for k, ref in enumerate((opos_ref, opos_ref, opos_ref,
                             ovel_ref, ovel_ref, ovel_ref)):
        plgpu.store(ref.at[k % 3, cols], state[k], mask=mask)


@functools.lru_cache(maxsize=None)
def _build(n: int, substeps: int, interpret: bool):
    plane = jax.ShapeDtypeStruct((3, n), jnp.float32)
    return pl.pallas_call(
        functools.partial(_kernel, n=n, substeps=substeps),
        backend="triton",
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=(plane, plane),
        input_output_aliases={1: 0, 2: 1},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="attractor_step",
        cost_estimate=pl.CostEstimate(
            flops=substeps * 30 * n,
            bytes_accessed=2 * 2 * 3 * n * 4,
            transcendentals=substeps * n,   # one rsqrt per step
        ),
    )


def step(
    pos: jax.Array,
    vel: jax.Array,
    param_vec: jax.Array,
    *,
    substeps: int = 1,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """``substeps`` fused attractor steps on (3, ...) planes of any shape.
    Traceable; donate pos/vel via jit."""
    shape = pos.shape
    n = pos.size // 3
    call = _build(n, substeps, interpret)
    p, v = call(param_vec.astype(jnp.float32).reshape(-1),
                pos.reshape(3, n), vel.reshape(3, n))
    return p.reshape(shape), v.reshape(shape)


@functools.partial(
    jax.jit, donate_argnums=(0, 1), static_argnames=("substeps", "interpret"),
)
def step_jit(pos, vel, param_vec, substeps: int = 1,
             interpret: bool = False):
    return step(pos, vel, param_vec, substeps=substeps, interpret=interpret)


@functools.partial(
    jax.jit, donate_argnums=(0, 1),
    static_argnames=("n_steps", "substeps", "interpret"),
)
def step_n_jit(pos, vel, param_vec, n_steps: int, substeps: int = 1,
               interpret: bool = False):
    """``n_steps`` kernel launches of ``substeps`` each, fused in one jit."""
    def body(_, c):
        return step(c[0], c[1], param_vec, substeps=substeps,
                    interpret=interpret)
    return jax.lax.fori_loop(0, n_steps, body, (pos, vel))
