"""Kernel-vs-reference and multi-device-vs-single-device parity checks.

One implementation of every comparison that decides whether a translated
path is right, shared by ``chip_smoke.py`` (full sizes on the GPU), the
card-only tests (``pytest -m gpu``) and the CPU tests (tiny sizes, kernels
in the Pallas interpreter, the 8-device virtual mesh). Each check returns a
dict with the measured error ``err``, its tolerance ``tol`` and ``ok``.

Tolerances, and why each is not zero:

  * attractor kernel vs ops/step_jnp.py: max |dpos| / max |pos| <= 1e-5.
    Same f32 operations in the same order, but the two compilers may
    contract a*b+c into one FMA differently and take rsqrt from different
    instructions; the few-ulp differences compound over substeps.
  * all-pairs kernel vs pairwise.pairwise_accel_blocked: relative L2
    <= 1e-5. Both sum 1e4-1e5 f32 terms per receiver in different orders
    (register tiles vs a reduction tree): ~sqrt(N) ulp of drift.
  * persistent PM vs pm.pm_accel_ref: rms relative <= 1e-4. Same deposit,
    solve and gather; the scatter-add's atomic adds land in a different
    order (slot order vs identity order, and run to run), and the FFT
    spreads each cell's few-ulp difference over the field.
  * raster: two renders of one frame differ by <= 1e-5 per channel (atomic
    scatter-add order varies run to run).
  * multi-device vs single device: the psum of per-device grids or
    framebuffers sums in another order — the same tolerances as above.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from ..parallel.mesh import DP_AXIS

ATTRACTOR_TOL = 1e-5
PAIRWISE_TOL = 1e-5
PM_TOL = 1e-4
RASTER_TOL = 1e-5


def _result(name: str, err: float, tol: float, **extra) -> dict:
    err = float(err)
    return {"check": name, "err": err, "tol": tol,
            "ok": bool(np.isfinite(err) and err <= tol), **extra}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rms_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / max(np.mean(b * b),
                                                      1e-30)))


def ball(n: int, seed: int = 0, radius: float = 40.0,
         core: float = 0.0) -> jax.Array:
    """f32[3, n] positions made on the device: uniform in a ball, with a
    fraction ``core`` of them in a dense core of radius/20."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    d = jax.random.normal(k1, (3, n), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    r = radius * jax.random.uniform(k2, (n,), jnp.float32) ** (1.0 / 3.0)
    if core:
        r = jnp.where(jax.random.uniform(k3, (n,)) < core, r / 20.0, r)
    return d * r[None]


def _planes(flat: jax.Array) -> jax.Array:
    return flat.reshape(3, -1, 128)


def _attractor_params():
    from ..core.params import SimParams
    return jnp.asarray(SimParams(
        gravity=1.0, is_mouse_dragging=True, mouse_position=(5.0, 3.0, 20.0),
        mouse_force=50.0, mouse_radius=25.0).pack())


# ---------------------------------------------------------------------------
# single device: kernel vs plain reference
# ---------------------------------------------------------------------------

def attractor(n: int, substeps: int, *, interpret: bool = False) -> dict:
    """ops/step_pallas.py vs ops/step_jnp.py after ``substeps`` steps, on
    flat (3, n) planes (any n: the kernel masks its last block)."""
    from ..ops import step_jnp, step_pallas

    pos = ball(n, seed=1)
    vel = jax.random.normal(jax.random.key(2), (3, n), jnp.float32)
    pv = _attractor_params()
    p_k, _ = step_pallas.step_jit(jnp.array(pos), jnp.array(vel), pv,
                                  substeps=substeps, interpret=interpret)
    p_r, _ = step_jnp.step_n_jit(jnp.array(pos), jnp.array(vel), pv,
                                 substeps)
    p_k, p_r = np.asarray(p_k), np.asarray(p_r)
    err = np.abs(p_k - p_r).max() / max(np.abs(p_r).max(), 1e-30)
    return _result(f"attractor_n{n}_sub{substeps}", err, ATTRACTOR_TOL)


def pairwise(n: int, *, interpret: bool = False) -> dict:
    """ops/pairwise_pallas.py vs the blocked f32 reference, with source
    masses and an active count that is no multiple of any tile."""
    from ..ops import pairwise as pw
    from ..ops import pairwise_pallas

    x = ball(n, seed=3)
    m = jax.random.uniform(jax.random.key(4), (n,), jnp.float32, 0.5, 2.0)
    n_act = n - 77
    a_k = jax.jit(lambda x, m: pairwise_pallas.pairwise_accel(
        x, x, n_act, 1.0, 0.5, masses=m, interpret=interpret))(x, m)
    a_r = jax.jit(lambda x, m: pw.pairwise_accel_blocked(
        x, x, n_act, 1.0, 0.5, masses=m))(x, m)
    return _result(f"pairwise_n{n}", _rel_l2(a_k, a_r), PAIRWISE_TOL)


def persist_pm(n: int, grid: int = 128) -> dict:
    """pm_persist.accel_sorted on a DRIFTED order (sorted for one set of
    positions, then moved) vs the per-frame pm.pm_accel_ref: ``n`` live
    particles in the engine's capacity (the next multiple of 1024)."""
    from ..core.params import PMConfig
    from ..ops import pm, pm_persist

    cfg = PMConfig(grid=grid, softening=2.0)
    cap = -(-n // 1024) * 1024
    p0 = ball(cap, seed=5, core=0.3)
    p1 = p0 + 0.5 * jax.random.normal(jax.random.key(6), p0.shape)
    n_act = jnp.int32(n)
    kers = pm.base_kernels_device(cfg, cfg.softening)
    st = pm_persist.init_sorted(p0, n_act, cfg)
    st = st._replace(pos=p1[:, st.ids])
    st, acc = jax.jit(lambda s, k: pm_persist.accel_sorted(
        s, 1.0, cfg, n_active=n_act, base_kernels=k))(st, kers)
    got = pm_persist.unsort(st, (acc,))[0]
    ref = jax.jit(lambda p, k: pm.pm_accel_ref(
        p, n_act, 1.0, cfg.softening, cfg, kernels=k))(p1, kers)
    live = int(n_act)
    return _result(f"persist_pm_n{n}_g{grid}",
                   _rms_rel(np.asarray(got)[:, :live],
                            np.asarray(ref)[:, :live]), PM_TOL,
                   repairs=int(st.resorts))


def raster(n: int, width: int = 1280, height: int = 720) -> dict:
    """render/raster.py: finite, not black, and stable across two runs."""
    from ..core.params import SimParams
    from ..render import raster as rs
    from ..render.camera import Camera

    pos = ball(n, seed=7, core=0.3)
    vel = jax.random.normal(jax.random.key(8), (3, n), jnp.float32)
    col = jnp.full(pos.shape, 0.7, jnp.float32)
    pv = jnp.asarray(SimParams(color_mode=1).pack())
    vp = jnp.asarray(Camera(aspect=width / height).view_proj())
    fbs = [np.asarray(rs.render_jit(pos, vel, col, pv, vp, jnp.int32(n),
                                    width=width, height=height))
           for _ in range(2)]
    finite = bool(np.isfinite(fbs[0]).all())
    lit = float(fbs[0].max())
    err = np.abs(fbs[0] - fbs[1]).max() if finite and lit > 0 else np.inf
    return _result(f"raster_n{n}_{width}x{height}", err, RASTER_TOL,
                   lit_pixels=int((fbs[0].max(axis=-1) > 0).sum()))


# ---------------------------------------------------------------------------
# multi-device (flat 1-D dp mesh) vs single device
# ---------------------------------------------------------------------------

def _shard(mesh, *planes):
    from ..parallel import mesh as mesh_lib
    return mesh_lib.shard_state_planes(mesh, *planes)


def mesh_attractor(mesh, n: int, substeps: int, *,
                   use_kernel: bool = False,
                   interpret: bool = False) -> dict:
    """parallel/dp.py sharded step vs the single-device stepper."""
    from ..ops import step_jnp, step_pallas
    from ..parallel import dp

    pos = _planes(ball(n, seed=11))
    vel = _planes(jax.random.normal(jax.random.key(12), (3, n), jnp.float32))
    pv = _attractor_params()
    step = dp.make_sharded_step(mesh, use_kernel=use_kernel,
                                substeps=substeps, interpret=interpret)
    p_m, _ = step(*_shard(mesh, jnp.array(pos), jnp.array(vel)), pv)
    if use_kernel:
        p_1, _ = step_pallas.step_jit(jnp.array(pos), jnp.array(vel), pv,
                                      substeps=substeps, interpret=interpret)
    else:
        p_1, _ = step_jnp.step_n_jit(jnp.array(pos), jnp.array(vel), pv,
                                     substeps)
    p_m, p_1 = np.asarray(p_m), np.asarray(p_1)
    err = np.abs(p_m - p_1).max() / max(np.abs(p_1).max(), 1e-30)
    kind = "kernel" if use_kernel else "xla"
    return _result(f"mesh_attractor_n{n}_sub{substeps}_{kind}", err,
                   ATTRACTOR_TOL)


def mesh_ring(mesh, n: int, *, use_kernel: bool = False,
              interpret: bool = False) -> dict:
    """parallel/ring.py ppermute all-pairs step vs the single-device
    pair pass (the same kick/step contract), compared on velocities."""
    from ..core.params import PairwiseParams
    from ..ops import pairwise as pw
    from ..ops import physics
    from ..parallel import ring

    pos = _planes(ball(n, seed=13))
    vel = jnp.zeros_like(pos)
    m = jax.random.uniform(jax.random.key(14), (n,), jnp.float32, 0.5, 2.0)
    pv = _attractor_params()
    pp = jnp.asarray(PairwiseParams(1.0, 0.5).pack())
    n_act = jnp.int32(n - 77)
    step = ring.make_ring_pairwise_step(mesh, use_kernel=use_kernel,
                                        interpret=interpret,
                                        with_masses=True)
    m_sh = jax.device_put(m, NamedSharding(mesh, PartitionSpec(DP_AXIS)))
    _, v_m = step(*_shard(mesh, jnp.array(pos), jnp.array(vel)), pv, pp,
                  n_act, m_sh)
    flat = pos.reshape(3, -1)
    acc = jax.jit(lambda f, m: pw.pairwise_accel_blocked(
        f, f, n_act, 1.0, 0.5, masses=m))(flat, m)
    _, v_1 = physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                          pv)
    return _result(f"mesh_ring_n{n}", _rel_l2(v_m, v_1), PAIRWISE_TOL)


def mesh_pm(mesh, n: int, grid: int = 128) -> dict:
    """parallel/pm_dp.py psum-grid PM step vs pm.step_pm_ref."""
    from ..core.params import PairwiseParams, PMConfig
    from ..ops import pm
    from ..parallel import pm_dp

    cfg = PMConfig(grid=grid, softening=2.0)
    pos = _planes(ball(n, seed=15, core=0.3))
    vel = jnp.zeros_like(pos)
    pv = _attractor_params()
    pp = jnp.asarray(PairwiseParams(1.0, cfg.softening).pack())
    n_act = jnp.int32(n - 333)
    kers = pm.base_kernels_device(cfg, cfg.softening)
    step = pm_dp.make_pm_step(mesh, cfg, with_base_kernels=True)
    _, v_m = step(*_shard(mesh, jnp.array(pos), jnp.array(vel)), pv, pp,
                  n_act, kers)
    _, v_1 = pm.step_pm_jit(jnp.array(pos), jnp.array(vel), pv, pp, n_act,
                            cfg, kernels=kers)
    live = n - 333
    return _result(f"mesh_pm_n{n}_g{grid}",
                   _rms_rel(np.asarray(v_m).reshape(3, -1)[:, :live],
                            np.asarray(v_1).reshape(3, -1)[:, :live]),
                   PM_TOL)


def mesh_persist_pm(mesh, n: int, grid: int = 128) -> dict:
    """parallel/pm_persist_dp.py (per-shard cell order, one grid psum) vs
    the single-device per-frame pm.step_pm_ref, in identity order."""
    from ..core.params import PairwiseParams, PMConfig
    from ..ops import pm
    from ..parallel import pm_persist_dp

    cfg = PMConfig(grid=grid, softening=2.0)
    pos = ball(n, seed=17, core=0.3)
    vel = jnp.zeros_like(pos)
    pv = _attractor_params()
    pp = jnp.asarray(PairwiseParams(1.0, cfg.softening).pack())
    n_act = jnp.int32(n - 333)
    kers = pm.base_kernels_device(cfg, cfg.softening)
    sh = NamedSharding(mesh, PartitionSpec(None, DP_AXIS))
    init = pm_persist_dp.make_persist_init(mesh, cfg)
    step = pm_persist_dp.make_persist_pm_step(mesh, cfg,
                                              with_base_kernels=True)
    carry = init(jax.device_put(pos, sh), jax.device_put(vel, sh), n_act)
    out = step(*carry, pv, pp, n_act, kers)
    ids = np.asarray(out[2])
    v_m = np.zeros((3, n), np.float32)
    v_m[:, ids] = np.asarray(out[1])
    _, v_1 = pm.step_pm_jit(_planes(pos), _planes(vel), pv, pp, n_act, cfg,
                            kernels=kers)
    live = n - 333
    return _result(f"mesh_persist_pm_n{n}_g{grid}",
                   _rms_rel(v_m[:, :live],
                            np.asarray(v_1).reshape(3, -1)[:, :live]),
                   PM_TOL)


def mesh_render(mesh, n: int, width: int = 1280,
                height: int = 720) -> dict:
    """parallel/render_dp.py (per-shard raster + framebuffer psum) vs one
    render/raster.py render of the same state."""
    from ..core.params import SimParams
    from ..parallel.render_dp import make_render_dp
    from ..render import raster as rs
    from ..render.camera import Camera

    pos = _planes(ball(n, seed=19, core=0.3))
    vel = _planes(jax.random.normal(jax.random.key(20), (3, n), jnp.float32))
    col = jnp.full(pos.shape, 0.7, jnp.float32)
    pv = jnp.asarray(SimParams(color_mode=1).pack())
    vp = jnp.asarray(Camera(aspect=width / height).view_proj())
    n_act = jnp.int32(n - 333)
    fn = make_render_dp(mesh, width=width, height=height)
    fb_m = np.asarray(fn(*_shard(mesh, pos, vel, col), pv, vp, n_act))
    fb_1 = np.asarray(rs.render_jit(pos, vel, col, pv, vp, n_act,
                                    width=width, height=height))
    err = (np.abs(fb_m - fb_1).max() if fb_1.max() > 0 else np.inf)
    return _result(f"mesh_render_n{n}_{width}x{height}", err, RASTER_TOL)
