"""Kepler disk: a million light particles orbiting a heavy central mass.

Builds a cold rotating disk in near-circular orbits (velocity from the
enclosed softened central force), evolves it with the particle-mesh solver
(heavy center deposited like any other particle via per-particle masses),
and renders frames.

    python examples/disk.py --count 1000000 --steps 600 --out frames/
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing


import numpy as np


def make_disk(n: int, m_center: float, g: float, eps: float,
              r_in: float = 8.0, r_out: float = 45.0, seed: int = 7,
              disk_mass_fraction: float = 0.1):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(r_in ** 2, r_out ** 2, n)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    z = rng.normal(scale=0.5, size=n).astype(np.float32)
    pos = np.stack([r * np.cos(th), z, r * np.sin(th)], axis=1)
    # circular speed for the softened central force; the total DISK mass
    # is capped at disk_mass_fraction * m_center (per-particle mass
    # m_center*frac/n) so self-gravity really is a perturbation
    v_circ = np.sqrt(g * m_center * r * r / (r * r + eps * eps) ** 1.5)
    vel = np.stack([-v_circ * np.sin(th), np.zeros_like(z),
                    v_circ * np.cos(th)], axis=1).astype(np.float32)
    # center body at rest at the origin
    pos = np.concatenate([np.zeros((1, 3), np.float32), pos])
    vel = np.concatenate([np.zeros((1, 3), np.float32), vel])
    masses = np.full(n + 1, disk_mass_fraction * m_center / n, np.float32)
    masses[0] = m_center
    return pos, vel, masses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--g", type=float, default=1.0)
    ap.add_argument("--central-mass", type=float, default=50_000.0)
    ap.add_argument("--softening", type=float, default=2.0)
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--out", default="")
    ap.add_argument("--render-every", type=int, default=60)
    args = ap.parse_args()

    from particle_sim_tpu.utils.cache import enable
    enable()

    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import PairwiseParams, PMConfig
    from particle_sim_tpu.engine import Engine
    from particle_sim_tpu.render.camera import Camera
    from particle_sim_tpu.utils.png import write_png

    pos, vel, masses = make_disk(args.count, args.central_mass, args.g,
                                 args.softening)
    # tiny placeholder count: the generated sphere is replaced immediately
    engine = Engine(
        particle_count=1,
        pairwise=PairwiseParams(args.g, args.softening),
        pm=PMConfig(softening=args.softening),
    )
    engine.state = psim.ParticleState.from_arrays(
        pos, vel, np.full_like(pos, 0.6))
    engine.set_masses(masses)
    params = psim.SimParams(delta_time=args.dt, color_mode=1, damping=1.0)
    camera = Camera(aspect=16 / 9,
                    position=np.array([0.0, 60.0, 90.0]), pitch=-0.6)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    for i in range(args.steps):
        engine.step(params)
        if (i + 1) % args.render_every == 0:
            d = engine.diagnostics()
            print(json.dumps({"step": i + 1, "mean_radius": d.mean_radius,
                              "max_speed": d.max_speed,
                              **engine.stats.snapshot()}))
            if args.out:
                img = engine.render_frame(camera, params,
                                          width=1280, height=720)
                write_png(os.path.join(args.out, f"d_{i + 1:05d}.png"), img)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
