"""Kernel and stage benchmark on one GPU — prints ONE JSON line.

Legs (``--legs``, default all):

  attractor  the fused attractor kernel (ops/step_pallas.py, Pallas on the
             Triton route) against what XLA makes of ops/step_jnp.py, at
             the reference's 1M particles: the interactive frame
             (substeps=1, one dispatch per frame, host loop), the same
             frames chained in one jit (device time), and the batch
             rate (one launch of 2048 vs 512 in-kernel substeps; the
             marginal per particle-step).
  pairwise   the all-pairs kernel (ops/pairwise_pallas.py) against the
             blocked plain-XLA form (pairwise.pairwise_accel_blocked) at
             16,384 and 65,536 particles, with masses and a ragged
             active count.
  pm         the particle-mesh stages — CIC deposit (XLA scatter-add),
             FFT solve, CIC gather — at G=128, 1M and 16M particles, on a
             uniform and a collapsed scene, plus the whole per-frame solve.
  raster     render/raster.py (XLA scatter-add blend) at 1M and 16M
             particles, 1280x720.

Every time is the median of ``--reps`` timed calls after a compile-and-warm
call, each ending in ``block_until_ready``. The result names the device it
ran on (platform, device_kind, count) and the card's name and power limit
from ``nvidia-smi``. A run that finds no GPU exits non-zero: these numbers
mean nothing on a CPU.

    python bench.py [--legs attractor pairwise pm raster] [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def gpu_info() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip()


# leg sizes (module constants, so a quick CPU dry run can shrink them)
ATTRACTOR_N = 1_000_000
PAIRWISE_NS = (16_384, 65_536)
PM_NS = (1_000_000, 16_000_000)
RASTER_NS = (1_000_000, 16_000_000)


def timed(fn, *args, reps: int = 10) -> float:
    """Median milliseconds of ``fn(*args)`` after one warm (compiling) call;
    each timed call ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _scene(n: int, kind: str, seed: int = 0):
    """f32[3, n] positions made on the device: ``uniform`` fills a ball of
    radius 50, ``collapsed`` puts 90% of the particles in a core of
    radius 2 (the dense-cell contention case of a scatter-add)."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    d = jax.random.normal(k1, (3, n), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    r = 50.0 * jax.random.uniform(k2, (n,), jnp.float32) ** (1.0 / 3.0)
    if kind == "collapsed":
        core = jax.random.uniform(k3, (n,)) < 0.9
        r = jnp.where(core, r * (2.0 / 50.0), r)
    return d * r[None]


def leg_attractor(reps: int) -> dict:
    import jax.numpy as jnp

    import particle_sim_tpu as psim
    from particle_sim_tpu.ops import step_jnp, step_pallas

    pos, vel, col = psim.generate.generate(ATTRACTOR_N,
                                           psim.SphereGeneration.HOLLOW)
    st = psim.ParticleState.from_arrays(pos, vel, col)
    pv = jnp.asarray(psim.SimParams(
        gravity=1.0, is_mouse_dragging=True, mouse_position=(0.0, 0.0, 48.0),
        mouse_force=50.0, mouse_radius=25.0).pack())
    frames = 200

    def frame_loop(step):
        def run(p, v):
            for _ in range(frames):
                p, v = step(p, v)
            return p, v
        return run

    out = {"particles": st.capacity}
    loops = {
        "triton": frame_loop(lambda p, v: step_pallas.step_jit(p, v, pv)),
        "xla": frame_loop(lambda p, v: step_jnp.step_jit(p, v, pv)),
    }
    for name, run in loops.items():
        t = timed(lambda: run(jnp.array(st.pos), jnp.array(st.vel)),
                  reps=max(3, reps // 3))
        out[f"frame_ms_{name}"] = t / frames
    # the same frames chained in one jit: one launch per frame, no host
    # dispatch between them, so the time per frame is the device's
    chains = {
        "triton": lambda p, v: step_pallas.step_n_jit(p, v, pv, frames,
                                                      substeps=1),
        "xla": lambda p, v: step_jnp.step_n_jit(p, v, pv, frames),
    }
    for name, run in chains.items():
        t = timed(lambda: run(jnp.array(st.pos), jnp.array(st.vel)),
                  reps=reps)
        out[f"chain_ms_{name}"] = t / frames
    batch = {
        "triton": lambda p, v, s: step_pallas.step_n_jit(p, v, pv, 1,
                                                         substeps=s),
        "xla": lambda p, v, s: step_jnp.step_n_jit(p, v, pv, s),
    }
    for name, run in batch.items():
        t = {s: timed(lambda s=s: run(jnp.array(st.pos),
                                      jnp.array(st.vel), s), reps=reps)
             for s in (512, 2048)}
        out[f"batch_ms_512_{name}"] = t[512]
        out[f"batch_ms_2048_{name}"] = t[2048]
        out[f"batch_particle_steps_per_s_{name}"] = (
            1536 * st.capacity / max(t[2048] - t[512], 1e-6) * 1e3)
    return out


def leg_pairwise(reps: int) -> dict:
    import jax
    import jax.numpy as jnp

    from particle_sim_tpu.ops import pairwise, pairwise_pallas

    out = {}
    for n in PAIRWISE_NS:
        x = _scene(n, "uniform", seed=1)
        m = jax.random.uniform(jax.random.key(2), (n,), jnp.float32,
                               0.5, 2.0)
        n_act = n - 77
        kern = jax.jit(lambda x, m: pairwise_pallas.pairwise_accel(
            x, x, n_act, 1.0, 0.5, masses=m))
        ref = jax.jit(lambda x, m: pairwise.pairwise_accel_blocked(
            x, x, n_act, 1.0, 0.5, masses=m))
        out[f"ms_{n}_triton"] = timed(kern, x, m, reps=reps)
        out[f"ms_{n}_xla"] = timed(ref, x, m, reps=reps)
        a, b = kern(x, m), ref(x, m)
        out[f"rel_l2_{n}"] = float(jnp.linalg.norm(a - b)
                                   / jnp.linalg.norm(b))
    return out


def leg_pm(reps: int) -> dict:
    import functools

    import jax
    import jax.numpy as jnp

    from particle_sim_tpu.core.params import PMConfig
    from particle_sim_tpu.ops import pm

    cfg = PMConfig(grid=128, softening=2.0)
    kers = pm.base_kernels_device(cfg, cfg.softening)
    coords = jax.jit(lambda p: pm.cell_coords(p, cfg))
    dep = jax.jit(lambda c, m: pm.cic_deposit(c, m, cfg.grid))
    solve = jax.jit(lambda rho, k: pm.solve_accel(rho, cfg, cfg.softening,
                                                  kernels=k))
    gat = jax.jit(lambda g, c: pm.cic_gather(g, c, cfg.grid))
    full = jax.jit(functools.partial(pm.pm_accel_ref, g_const=1.0,
                                     softening=cfg.softening, cfg=cfg))
    out = {}
    for n in PM_NS:
        for kind in ("uniform", "collapsed"):
            tag = f"{n}_{kind}"
            p = _scene(n, kind)
            c = coords(p)
            m = jnp.ones((n,), jnp.float32)
            rho = dep(c, m)
            grids = solve(rho, kers)
            out[f"deposit_ms_{tag}"] = timed(dep, c, m, reps=reps)
            out[f"solve_ms_{tag}"] = timed(solve, rho, kers, reps=reps)
            out[f"gather_ms_{tag}"] = timed(gat, grids, c, reps=reps)
            out[f"frame_ms_{tag}"] = timed(
                lambda p: full(p, jnp.int32(n), kernels=kers), p,
                reps=reps)
            del p, c, m, rho, grids
    return out


def leg_raster(reps: int) -> dict:
    import jax
    import jax.numpy as jnp

    import particle_sim_tpu as psim
    from particle_sim_tpu.render import raster
    from particle_sim_tpu.render.camera import Camera

    vp = jnp.asarray(Camera(aspect=1280 / 720).view_proj())
    pv = jnp.asarray(psim.SimParams(color_mode=1).pack())
    out = {}
    for n in RASTER_NS:
        for kind in ("uniform", "collapsed"):
            p = _scene(n, kind)
            v = jax.random.normal(jax.random.key(3), p.shape, jnp.float32)
            c = jnp.full(p.shape, 0.5, jnp.float32)
            fn = lambda p, v, c: raster.render_jit(
                p, v, c, pv, vp, jnp.int32(n), width=1280, height=720)
            out[f"ms_{n}_{kind}"] = timed(fn, p, v, c, reps=reps)
            del p, v, c
    return out


LEGS = {"attractor": leg_attractor, "pairwise": leg_pairwise,
        "pm": leg_pm, "raster": leg_raster}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", nargs="+", choices=sorted(LEGS),
                    default=list(LEGS))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import jax

    from particle_sim_tpu.utils.cache import enable as enable_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    enable_cache()
    card = gpu_info()
    res = {"device": {"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs)},
           "card": card, "legs": {}}
    t0 = time.perf_counter()
    for name in args.legs:
        res["legs"][name] = LEGS[name](args.reps)
    res["wall_s"] = time.perf_counter() - t0
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
