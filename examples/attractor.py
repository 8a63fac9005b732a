"""The reference's core interaction, scripted: a million particles chasing
an orbiting attractor (the left-drag behavior of app.rs:244-280, headless).

    python examples/attractor.py --count 1000000 --steps 600
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import json

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--force", type=float, default=50.0)
    ap.add_argument("--radius", type=float, default=25.0)
    args = ap.parse_args()

    from particle_sim_tpu.utils.cache import enable
    enable()

    import particle_sim_tpu as psim
    from particle_sim_tpu.engine import Engine

    engine = Engine(particle_count=args.count)
    base = psim.SimParams(is_mouse_dragging=True, mouse_force=args.force,
                          mouse_radius=args.radius, color_mode=1)
    for i in range(args.steps):
        ang = i * 0.02
        engine.step(base.replace(mouse_position=(
            40 * np.cos(ang), 10 * np.sin(2.3 * ang), 40 * np.sin(ang))))
        if (i + 1) % 100 == 0:
            d = engine.diagnostics()
            print(json.dumps({"step": i + 1, "mean_radius": d.mean_radius,
                              "max_speed": d.max_speed,
                              **engine.stats.snapshot()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
