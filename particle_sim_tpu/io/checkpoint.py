"""Checkpoint / resume — capability extension over the reference.

The reference has no persistence: the closest features are Pause (a bool
gate, ``mod.rs:48-49``) and Reset (regenerate, ``cpu.rs:172-186``); a crash
loses the cloud (SURVEY.md §5 failure detection). Because our state is three
SoA arrays, snapshots are cheap: positions, velocities, init colors sliced
to the active count, plus scene metadata — a single .npz. This is the
preemption-recovery story for long runs: periodic snapshot, resume on a
fresh machine.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

import dataclasses

from ..core.params import Method, PairwiseParams, PMConfig, SphereGeneration
from ..core.state import ParticleState
from ..engine import Engine

FORMAT_VERSION = 1


def save(path: str, engine: Engine, step_index: int = 0) -> None:
    engine.ensure_identity_order()
    state = engine.state
    meta = {
        "format_version": FORMAT_VERSION,
        "generation_mode": int(engine.generation_mode),
        "method": int(engine.method),
        "paused": engine.paused,
        "step_index": step_index,
        "substeps": engine.substeps,
        "pairwise": (
            [engine.pairwise.gravitational_constant, engine.pairwise.softening]
            if engine.pairwise else None),
        "pm": dataclasses.asdict(engine.pm) if engine.pm else None,
        "pm_persist": engine.pm_persist,
        # single PM2Config -> dict; multi-level tuple -> list of dicts
        "pm2": (
            [dataclasses.asdict(c) for c in engine.pm2]
            if isinstance(getattr(engine, "pm2", None), tuple)
            else dataclasses.asdict(engine.pm2)
            if getattr(engine, "pm2", None) else None),
        "pmx": (dataclasses.asdict(engine.pmx)
                if getattr(engine, "pmx", None) else None),
        "two_tier": getattr(engine, "two_tier", True),
    }
    arrays = dict(
        positions=state.positions(),
        velocities=state.velocities(),
        init_colors=np.asarray(
            state.init_color.reshape(3, -1)[:, : engine.particle_count]).T,
        meta=json.dumps(meta),
    )
    if engine.masses is not None:
        # _masses_for_capacity repads after resizes; the raw buffer can be
        # stale (shorter than the current count) right after a grow
        arrays["masses"] = np.asarray(
            engine._masses_for_capacity()[: engine.particle_count])
    # atomic: a preemption mid-save (the very event checkpoints exist
    # for) must not truncate the previous good checkpoint
    tmp = f"{path}.tmp"
    np.savez_compressed(tmp, **arrays)
    actual = tmp if os.path.exists(tmp) else tmp + ".npz"  # np may append
    os.replace(actual, path)


def load(path: str, method: Optional[Method] = None,
         interpret: bool = False) -> tuple:
    """-> (Engine, step_index). ``method`` overrides the saved backend (a
    checkpoint from a GPU run can resume on CPU, like the reference's
    backend hot-swap but state-preserving)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version: {meta}")
        positions = z["positions"]
        velocities = z["velocities"]
        init_colors = z["init_colors"]
        masses = z["masses"] if "masses" in z.files else None

    pair = meta.get("pairwise")
    pm_meta = meta.get("pm")
    if pm_meta:
        pm_meta["box_min"] = tuple(pm_meta["box_min"])
    pm2_cfg = None
    pm2_meta = meta.get("pm2")
    if pm2_meta:
        from ..ops.pm2 import PM2Config

        def _one(d):
            if d.get("window_min") is not None:
                d["window_min"] = tuple(d["window_min"])
            return PM2Config(**d)

        pm2_cfg = (tuple(_one(d) for d in pm2_meta)
                   if isinstance(pm2_meta, list) else _one(pm2_meta))
    # older checkpoints may hold the retired mode "auto": it resumes on the
    # default (per-frame PM) instead of forcing the persistent order
    persist = meta.get("pm_persist") is True
    pmx_cfg = None
    pmx_meta = meta.get("pmx")
    if pmx_meta:
        from ..ops.pmx import PMXConfig
        if pmx_meta.get("window_min") is not None:
            pmx_meta["window_min"] = tuple(pmx_meta["window_min"])
        pmx_cfg = PMXConfig(**pmx_meta)
    engine = Engine(
        particle_count=1,  # placeholder; state is replaced below
        method=method if method is not None else Method(meta["method"]),
        generation_mode=SphereGeneration(meta["generation_mode"]),
        pairwise=PairwiseParams(*pair) if pair else None,
        pm=PMConfig(**pm_meta) if pm_meta else None,
        interpret=interpret,
        substeps=meta.get("substeps", 1),
        pm_persist=persist,
        pm2=pm2_cfg,
        pmx=pmx_cfg,
        two_tier=meta.get("two_tier", True),
    )
    engine.state = ParticleState.from_arrays(positions, velocities, init_colors)
    if masses is not None:
        engine.set_masses(masses)
    engine.paused = bool(meta["paused"])
    return engine, int(meta["step_index"])
