"""Deep zoom: MULTI-level PM on the PERSISTENT order — the flagship
solver composition.

A halo hosting a compact cluster hosting a dense core: three dynamical
scales, no single softening can resolve them all. The nested refinement
stack (pm2 tuple, windows auto-tracking each parent level's centroid)
gives every pair the softening of the innermost window containing it,
and ``pm_persist=True`` runs EVERY level sort-free on the k+1-class
persistent order (ops/pm_persist.accel_sorted_multi): steady-state
frames pay zero global sorts, repairs fire only when drift overflows
the span budgets or a particle crosses a frozen window boundary.

    python examples/deep_zoom.py --count 500000 --steps 300 --out frames/
    JAX_PLATFORMS=cpu python examples/deep_zoom.py --count 3000 --steps 6

The same configuration via the CLI / server:

    python -m particle_sim_tpu.app.cli --count 16777216 --pm --pm-persist \
        --pm2-size 32 8 --pm2-softening 0.6 0.2 --steps 600
    python -m particle_sim_tpu.app.server --count 16777216 --pm-persist \
        --pm2-size 32 8 --pm2-softening 0.6 0.2 --view-mode raster
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing


import numpy as np


def make_scene(n: int, seed: int = 13):
    """Halo (r=40) + cluster (r=4 at offset) + core (r=0.8 inside it)."""
    rng = np.random.default_rng(seed)
    n_core, n_cl = n // 4, n // 4
    center = np.float32([14.0, 6.0, -4.0])

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + off

    pos = np.concatenate([ball(n_core, 0.8, center),
                          ball(n_cl, 4.0, center),
                          ball(n - n_core - n_cl, 40.0, 0.0)])
    vel = np.zeros_like(pos)
    # solid-body spin for the cluster+core so the stack has something
    # to track (the centroid orbits slightly as the halo responds)
    rel = pos[: n_core + n_cl] - center
    vel[: n_core + n_cl, 0] = -0.25 * rel[:, 2]
    vel[: n_core + n_cl, 2] = 0.25 * rel[:, 0]
    return pos, vel


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=500_000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--g", type=float, default=0.05)
    ap.add_argument("--out", default="")
    ap.add_argument("--stats-every", type=int, default=50)
    ap.add_argument("--exact", action="store_true",
                    help="terminate the stack with the window-EXACT "
                         "pmx correction (ops/pmx.py): core pairs feel "
                         "the exact 0.05 softening via the all-pairs "
                         "kernel over the contiguous innermost class")
    args = ap.parse_args()

    import particle_sim_tpu as psim
    from particle_sim_tpu.engine import Engine
    from particle_sim_tpu.render.camera import Camera
    from particle_sim_tpu.utils.png import write_png

    pos, vel = make_scene(args.count)
    engine = Engine(
        particle_count=args.count,
        pm=psim.PMConfig(softening=3.0),
        pairwise=psim.PairwiseParams(args.g, 3.0),
        # nested stack: 32-unit window at 0.6 softening, 8-unit window
        # at 0.2 — each auto-tracking its parent level's centroid
        pm2=(psim.PM2Config(window_min=None, window_size=32.0,
                            softening=0.6),
             psim.PM2Config(window_min=None, window_size=8.0,
                            softening=0.2)),
        pm_persist=True,   # every level sort-free (k+1-class order)
        # --exact: the full flagship composition — halo -> nested
        # windows -> EXACT core, all sort-free (the member buffer is a
        # dynamic slice of the innermost class)
        pmx=(psim.PMXConfig(window_size=2.0, softening=0.05,
                            capacity=8192) if args.exact else None),
    )
    st = psim.ParticleState.from_arrays(
        pos, vel, np.full_like(pos, 0.7), capacity=engine.capacity)
    engine.state = st

    params = psim.SimParams(delta_time=0.016, gravity=0.0)
    cam = Camera()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    n_core = args.count // 4
    for i in range(args.steps):
        engine.step(params)
        if (i + 1) % args.stats_every == 0:
            p = engine.state.positions()
            core = p[:n_core]
            c = core.mean(axis=0)
            r_half = float(np.median(np.linalg.norm(core - c, axis=1)))
            rep = (int(engine._persist.resorts)
                   if engine._persist is not None else 0)
            print(f"step {i + 1}: core centroid {np.round(c, 2)}, "
                  f"half-mass radius {r_half:.3f}, repairs {rep}",
                  flush=True)
            if args.out:
                img = engine.render_frame(cam, params, width=1280,
                                          height=720)
                write_png(os.path.join(args.out,
                                       f"frame_{i + 1:06d}.png"), img)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
