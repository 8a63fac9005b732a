"""Cluster core: two-level PM resolving a dense star-cluster center.

A compact cluster (sub-coarse-cell core) embedded in a diffuse halo.
Single-level PM smooths the core's internal dynamics away (softening is
pinned at >= ~2.5 coarse cells); the two-level refinement window —
auto-tracking the mass centroid as the cluster orbits — restores
fine-softened forces inside it. Prints core/halo diagnostics per stats
interval; optionally renders frames.

    python examples/cluster_core.py --count 200000 --steps 400 --out frames/
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing


import numpy as np


def make_scene(n: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    n_core = n // 2
    core = rng.normal(scale=1.5, size=(n_core, 3)).astype(np.float32)
    core += np.float32([18.0, 0.0, 0.0])
    halo_dir = rng.normal(size=(n - n_core, 3)).astype(np.float32)
    halo_dir /= np.linalg.norm(halo_dir, axis=1, keepdims=True)
    halo_r = 40.0 * rng.random(n - n_core).astype(np.float32) ** (1 / 3)
    halo = halo_dir * halo_r[:, None]
    pos = np.concatenate([core, halo])
    # mild solid-body spin for the core so it does not instantly collapse
    vel = np.zeros_like(pos)
    rel = core - np.float32([18.0, 0.0, 0.0])
    vel[:n_core, 0] = -0.3 * rel[:, 2]
    vel[:n_core, 2] = 0.3 * rel[:, 0]
    return pos, vel


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=200_000)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--g", type=float, default=0.05)
    ap.add_argument("--window", type=float, default=24.0)
    ap.add_argument("--fine-softening", type=float, default=0.6)
    ap.add_argument("--out", default="")
    ap.add_argument("--stats-every", type=int, default=50)
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
        pm2=psim.PM2Config(window_min=None, window_size=args.window,
                           softening=args.fine_softening),
    )
    st = psim.ParticleState.from_arrays(
        pos, vel, np.full_like(pos, 0.7), capacity=engine.capacity)
    engine.state = st

    params = psim.SimParams(delta_time=0.016, gravity=0.0)
    cam = Camera()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    n_core = args.count // 2
    for i in range(args.steps):
        engine.step(params)
        if (i + 1) % args.stats_every == 0:
            p = engine.state.positions()
            core = p[:n_core]
            c = core.mean(axis=0)
            r_half = float(np.median(np.linalg.norm(core - c, axis=1)))
            print(f"step {i + 1}: core centroid {np.round(c, 2)}, "
                  f"half-mass radius {r_half:.2f}", flush=True)
            if args.out:
                img = engine.render_frame(cam, params, width=1280,
                                          height=720)
                write_png(os.path.join(args.out,
                                       f"frame_{i + 1:06d}.png"), img)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
