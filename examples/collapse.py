"""Self-gravitating collapse of a million-particle cloud (particle-mesh).

Runs the PM solver with the auto-zoom box, tracks energy/virial diagnostics,
and writes a frame sequence.

    python examples/collapse.py --count 1000000 --steps 600 --out frames/
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--g", type=float, default=0.08)
    ap.add_argument("--softening", type=float, default=4.0)
    ap.add_argument("--dt", type=float, default=0.004)
    ap.add_argument("--out", default="")
    ap.add_argument("--render-every", type=int, default=60)
    args = ap.parse_args()

    from particle_sim_tpu.utils.cache import enable
    enable()

    import particle_sim_tpu as psim
    from particle_sim_tpu.core.params import (
        PairwiseParams, PMConfig,
    )
    from particle_sim_tpu.engine import Engine
    from particle_sim_tpu.render.camera import Camera
    from particle_sim_tpu.utils.png import write_png

    engine = Engine(
        particle_count=args.count,
        generation_mode=psim.SphereGeneration.FILLED,
        pairwise=PairwiseParams(args.g, args.softening),
        pm=PMConfig(softening=args.softening, auto_box=True),
    )
    params = psim.SimParams(delta_time=args.dt, color_mode=1,
                            damping=1.0)  # undamped: watch the energy
    camera = Camera(aspect=16 / 9)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    for i in range(args.steps):
        engine.step(params)
        if (i + 1) % args.render_every == 0:
            d = engine.diagnostics(potential=True)
            print(json.dumps({"step": i + 1, **d.as_dict()}))
            if args.out:
                img = engine.render_frame(camera, params,
                                          width=1280, height=720)
                write_png(os.path.join(args.out, f"c_{i + 1:05d}.png"), img)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
