"""Headless CLI driver — the frame loop of ``app.rs:521-618`` without a
window: scripted attractor input, periodic frame renders to PNG, periodic
checkpoints, stats to stdout.

The reference exposes no CLI (all tunables are egui-mutated compile-time
defaults, SURVEY.md §5 config); headless device runs need one, mirroring the
full parameter surface of ``SimParams`` + the UI panel (mouse radius/force
sliders, gravity, color mode, particle count, generation mode —
``app.rs:320-518``).

Example:
    python -m particle_sim_tpu.app.cli --count 100000 --steps 300 \
        --drag --orbit-mouse --render-every 100 --render-dir frames/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="particle_sim_tpu", description=__doc__.split("\n")[0])
    p.add_argument("--count", type=int, default=None,
                   help="particle count (default: backend default, "
                        "100k jnp / 1M pallas — app.rs:108,117)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--method", choices=["auto", "jnp", "pallas"],
                   default="auto")
    p.add_argument("--generation", choices=["hollow", "filled"],
                   default="hollow")
    p.add_argument("--substeps", type=int, default=1)
    p.add_argument("--mesh", choices=["none", "auto"], default="none",
                   help="auto: shard particles over all visible devices "
                        "(dp axis; pairwise mode uses the ppermute ring)")
    # SimParams surface (defaults = mod.rs:69-84 / app.rs:143-148)
    p.add_argument("--dt", type=float, default=0.016)
    p.add_argument("--gravity", type=float, default=0.0)
    p.add_argument("--mouse-force", type=float, default=5.0)
    p.add_argument("--mouse-radius", type=float, default=10.0)
    p.add_argument("--mouse-pos", type=float, nargs=3,
                   default=[0.0, 0.0, 48.0])
    p.add_argument("--drag", action="store_true",
                   help="hold the attractor on (left-drag analog)")
    p.add_argument("--orbit-mouse", action="store_true",
                   help="script the attractor on a circular orbit")
    p.add_argument("--color-mode", type=int, choices=[0, 1, 2], default=0)
    p.add_argument("--max-dist-for-color", type=float, default=50.0)
    p.add_argument("--damping", type=float, default=0.99)
    # pairwise extension
    p.add_argument("--pairwise", action="store_true")
    p.add_argument("--pairwise-g", type=float, default=1.0)
    p.add_argument("--pairwise-softening", type=float, default=0.5)
    p.add_argument("--central-mass", type=float, default=0.0,
                   help="give particle 0 this source mass (heavy central "
                        "body for --pairwise/--pm runs)")
    # particle-mesh solver (O(N) self-gravity; implies --pairwise physics)
    p.add_argument("--pm", action="store_true",
                   help="solve the pairwise gravity with the particle-mesh "
                        "FFT solver (millions of particles per frame)")
    p.add_argument("--pm-grid", type=int, default=128)
    p.add_argument("--pm-softening", type=float, default=2.0,
                   help="Plummer eps for the PM solver; keep >= ~2 cell "
                        "sizes or short-range forces fall below mesh "
                        "resolution (PMConfig docs)")
    p.add_argument("--pm-box", type=float, nargs=4,
                   default=[-64.0, -64.0, -64.0, 128.0],
                   metavar=("XMIN", "YMIN", "ZMIN", "SIZE"))
    p.add_argument("--pm-boundary", choices=["isolated", "periodic"],
                   default="isolated")
    p.add_argument("--pm-auto-box", action="store_true",
                   help="track the cloud with a traced box every step "
                        "(auto-zoom; --pm-softening is then in CELL units)")
    p.add_argument("--pm-gradient", choices=["exact", "fd"], default="exact")
    p.add_argument("--pm2-size", type=float, nargs="+", default=[0.0],
                   help="two-level PM: refinement window extent (enables "
                        "the fine level; window follows the mass centroid "
                        "unless --pm2-window is given). SEVERAL values "
                        "(outermost first) nest a MULTI-level solver "
                        "(pm2.pmn_accel_ref), each window tracking the "
                        "centroid of the level above's members")
    p.add_argument("--pm2-window", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="two-level PM: static origin of the OUTERMOST "
                        "window (deeper levels always auto-track)")
    p.add_argument("--pm2-softening", type=float, nargs="+", default=[0.5],
                   help="fine-level Plummer softening (resolve >= "
                        "~2.5 * pm2-size/128); one value per --pm2-size "
                        "level when multi-level")
    p.add_argument("--pm2-margin", type=float, default=0.0)
    p.add_argument("--pmx-size", type=float, default=0.0,
                   help="window-EXACT short-range forces (ops/pmx.py): "
                        "extent of the tracked window whose member pairs "
                        "feel the exact --pmx-softening force instead of "
                        "the mesh-softened one; nests inside the "
                        "innermost --pm2-size level (implies --pm)")
    p.add_argument("--pmx-softening", type=float, default=0.1,
                   help="exact pair softening inside the --pmx-size "
                        "window (> 0, < the innermost mesh softening)")
    p.add_argument("--pmx-capacity", type=int, default=65536,
                   help="static member budget of the exact window's "
                        "all-pairs buffer (multiple of 512)")
    p.add_argument("--pm-persist", action="store_true",
                   help="persistent cell-ordered PM state (particles "
                        "stay in cell order between repairs; needs a "
                        "grid of 32/64/128/256 and a static box)")
    p.add_argument("--no-two-tier", action="store_true",
                   help="repair the persistent order with the full sort "
                        "only, skipping the segment-local tier-1 pass — "
                        "for violent scenes whose bulk motion crosses "
                        "segments (ops/pm_persist.py)")
    # rendering
    p.add_argument("--render-every", type=int, default=0)
    p.add_argument("--render-dir", default="frames")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    # checkpointing
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint", default="checkpoint.npz")
    p.add_argument("--resume", default=None)
    p.add_argument("--stats-every", type=int, default=100)
    p.add_argument("--diagnostics", action="store_true",
                   help="include physics observables (energy, momentum, "
                        "radius) in the periodic stats lines")
    return p


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """Run the CLI and return the Engine it drove (main() is the entry
    point; this is for callers that inspect the engine afterwards)."""
    args = build_parser().parse_args(argv)

    from ..utils.cache import enable as enable_compile_cache
    enable_compile_cache()

    import jax

    from ..core.params import (
        Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
    )
    from ..engine import Engine
    from ..io import checkpoint as ckpt
    from ..render.camera import Camera
    from ..utils.png import write_png

    method = {"auto": None, "jnp": Method.JNP,
              "pallas": Method.PALLAS}[args.method]
    start_step = 0
    if args.resume:
        engine, start_step = ckpt.load(args.resume, method=method)
        print(f"resumed from {args.resume} at step {start_step} "
              f"({engine.particle_count} particles)", file=sys.stderr)
        ignored = [name for name, given in (
            ("--mesh", args.mesh != "none"), ("--count", args.count),
            ("--pm", args.pm), ("--pm-persist", args.pm_persist),
            ("--pairwise", args.pairwise),
            ("--substeps", args.substeps != 1),
            ("--generation", args.generation != "hollow"),
        ) if given]
        if ignored:
            print(f"note: {', '.join(ignored)} ignored on --resume "
                  "(the checkpoint's configuration wins)", file=sys.stderr)
    else:
        mesh = None
        if args.mesh == "auto":
            from ..parallel import mesh as mesh_lib
            if len(jax.devices()) > 1:
                mesh = mesh_lib.make_mesh()
                print(f"mesh: dp over {mesh.devices.size} devices",
                      file=sys.stderr)
        # --pm-persist / --pm2-size are PM solver modes: imply --pm (the
        # server does the same, app/server.py want_pm)
        if args.pm_persist or args.pm2_size[0] > 0.0 or args.pmx_size > 0.0:
            args.pm = True
        pm_cfg = None
        if args.pm:
            pm_cfg = PMConfig(
                grid=args.pm_grid,
                box_min=tuple(args.pm_box[:3]), box_size=args.pm_box[3],
                softening=args.pm_softening,
                boundary=args.pm_boundary, gradient=args.pm_gradient,
                auto_box=args.pm_auto_box)
        pm2_cfg = None
        if args.pm2_size[0] > 0.0:
            from ..ops.pm2 import PM2Config
            sizes = args.pm2_size
            softs = args.pm2_softening
            if len(sizes) > 1 and len(softs) != len(sizes):
                p_err = ("--pm2-softening needs one value per --pm2-size "
                         f"level ({len(sizes)} sizes, {len(softs)} "
                         "softenings)")
                raise SystemExit(p_err)
            levels = tuple(PM2Config(
                window_min=(tuple(args.pm2_window)
                            if k == 0 and args.pm2_window else None),
                window_size=sz,
                softening=softs[min(k, len(softs) - 1)],
                margin=args.pm2_margin)
                for k, sz in enumerate(sizes))
            pm2_cfg = levels if len(levels) > 1 else levels[0]
        pmx_cfg = None
        if args.pmx_size > 0.0:
            from ..ops.pmx import PMXConfig
            pmx_cfg = PMXConfig(window_size=args.pmx_size,
                                softening=args.pmx_softening,
                                capacity=args.pmx_capacity)
        engine = Engine(
            particle_count=args.count,
            method=method,
            generation_mode=(SphereGeneration.HOLLOW
                             if args.generation == "hollow"
                             else SphereGeneration.FILLED),
            pairwise=(PairwiseParams(
                args.pairwise_g,
                args.pm_softening if args.pm else args.pairwise_softening)
                      if (args.pairwise or args.pm) else None),
            pm=pm_cfg,
            substeps=args.substeps,
            mesh=mesh,
            pm_persist=True if args.pm_persist else None,
            pm2=pm2_cfg,
            pmx=pmx_cfg,
            two_tier=not args.no_two_tier,
        )

    if args.central_mass > 0.0:
        # applies to fresh AND resumed runs (overrides checkpoint masses)
        m = np.ones(engine.particle_count, np.float32)
        m[0] = args.central_mass
        engine.set_masses(m)

    camera = Camera(aspect=args.width / args.height)
    if args.render_every:
        os.makedirs(args.render_dir, exist_ok=True)

    base = SimParams(
        delta_time=args.dt, gravity=args.gravity,
        color_mode=args.color_mode, mouse_force=args.mouse_force,
        mouse_radius=args.mouse_radius,
        is_mouse_dragging=args.drag or args.orbit_mouse,
        damping=args.damping, max_dist_for_color=args.max_dist_for_color,
        mouse_position=tuple(args.mouse_pos),
    )

    t_start = time.perf_counter()
    for i in range(start_step, start_step + args.steps):
        params = base
        if args.orbit_mouse:
            ang = i * 0.02
            params = base.replace(mouse_position=(
                40.0 * np.cos(ang), 10.0 * np.sin(ang * 2.3),
                40.0 * np.sin(ang)))
        engine.step(params)

        if args.render_every and (i + 1) % args.render_every == 0:
            img = engine.render_frame(camera, params,
                                      width=args.width, height=args.height)
            path = os.path.join(args.render_dir, f"frame_{i + 1:06d}.png")
            write_png(path, img)
            print(f"wrote {path}", file=sys.stderr)

        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(args.checkpoint, engine, step_index=i + 1)
            print(f"checkpointed -> {args.checkpoint}", file=sys.stderr)

        if args.stats_every and (i + 1) % args.stats_every == 0:
            line = {"step": i + 1, **engine.stats.snapshot()}
            if args.diagnostics:
                d = engine.diagnostics(potential=(args.pairwise or args.pm))
                if ((args.pairwise or args.pm) and d.potential is None
                        and i + 1 <= args.stats_every):
                    print("note: potential unavailable (N too large for "
                          "the direct sum and no PM config — use --pm)",
                          file=sys.stderr)
                line.update(d.as_dict())
            print(json.dumps(line))

    # final sync so the last step's cost is visible
    jax.block_until_ready(engine.state.pos)
    wall = time.perf_counter() - t_start
    total = args.steps * engine.substeps * engine.particle_count
    print(json.dumps({
        "done": True, "steps": args.steps, "wall_s": round(wall, 3),
        "particle_steps_per_sec": round(total / wall, 1),
        **engine.stats.snapshot(),
    }))
    return engine


if __name__ == "__main__":
    raise SystemExit(main())
