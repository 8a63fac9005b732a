"""Engine — the application-layer analog of the reference's ``ParticleApp``
simulation ownership (``/root/reference/src/app.rs:17-318``), headless.

Lifecycle semantics replicated from the reference:

  * **backend capability detection** (``app.rs:86-125``): the reference gates
    its compute-shader backend on a device probe and defaults to the best
    available with per-backend default counts (CPU 100k, compute 1M). Here:
    ``Method.PALLAS`` (the hand-written kernels) requires a GPU backend or
    explicit interpret mode, JNP runs everywhere; defaults mirror 100k
    (JNP) / 1M (PALLAS). ``select_paths`` is the one place that turns the
    method into the kernels each solver runs.
  * **pause** gates stepping entirely (``app.rs:283``, ``mod.rs:48-49``).
  * **reset** regenerates state at the current count (``cpu.rs:172-186``);
    Filled mode is reproducible across resets (fixed seed, ``mod.rs:170``).
  * **resize**: grow appends newly generated particles preserving existing
    state (the CPU backend's semantics, ``cpu.rs:136-147`` — SURVEY.md §3.3
    recommends unifying on this over the compute backend's
    regenerate-everything); shrink keeps over-allocated capacity and only
    drops the active count (both backends, ``cpu.rs:132-150``,
    ``compute.rs:188-190``). Like the reference's own quirk, appended Filled
    particles restart the fixed-seed stream (``cpu.rs:139`` constructs a
    fresh SmallRng(69)).
  * **method switch** builds a fresh backend with state regenerated — NOT
    migrated — preserving count and pause flag (``app.rs:172-200``).

Device mechanics: state planes live in device memory and are donated
through every jitted step (in-place double buffering); particle-count
changes map to padded capacity buckets so interactive resizing
(``app.rs:442-492``) only recompiles when the capacity bucket actually
changes.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core import generate as gen
from ..core.params import (
    ColorMode, Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
)
from ..core.state import LANE, ParticleState, capacity_rows
from ..ops import pairwise as pairwise_jnp
from ..ops import pairwise_pallas, step_jnp, step_pallas
from ..render import raster
from ..render.camera import Camera
from .stats import FrameStats

DEFAULT_COUNT_JNP = 100_000      # app.rs:108 (CPU backend default)
DEFAULT_COUNT_PALLAS = 1_000_000  # app.rs:117 (compute backend default)

logger = logging.getLogger("particle_sim_tpu.engine")


def _check_persist_cfg(pm) -> None:
    """Raise unless ``pm`` can run the persistent cell-ordered mode."""
    from ..ops import pm_persist as pper
    if pm is None:
        raise ValueError("pm_persist requires a PMConfig")
    if pm.auto_box or pm.grid not in pper.SUPPORTED_GRIDS:
        raise ValueError(
            "pm_persist needs a static box and a grid in "
            f"{pper.SUPPORTED_GRIDS} (got auto_box={pm.auto_box}, "
            f"grid={pm.grid})")


def available_methods(interpret: bool = False) -> list:
    """Capability probe analog (app.rs:86-100): the kernels of
    ``Method.PALLAS`` compile for a GPU (Pallas on the Triton route) and
    run anywhere else only in the Pallas interpreter, when the caller
    asks for it with ``interpret=True``."""
    methods = [Method.JNP]
    if jax.default_backend() == "gpu" or interpret:
        methods.append(Method.PALLAS)
    return methods


@dataclasses.dataclass(frozen=True)
class Paths:
    """Which hand-written kernel each solver runs (else plain XLA)."""
    step_kernel: bool   # attractor: ops/step_pallas.py
    pair_kernel: bool   # all-pairs: ops/pairwise_pallas.py (direct sum,
                        # ring hops, the pmx exact window)
    interpret: bool     # run those kernels in the Pallas interpreter


def select_paths(method: Method, substeps: int,
                 interpret: bool = False) -> Paths:
    """The engine's one path-selection rule (PERF.md has the numbers).

    The attractor kernel keeps a block's state in registers across its
    in-kernel substeps, so it wins only when there are several: at
    substeps=1 XLA's fusion of ops/step_jnp.py is as fast, and the
    interactive frame runs that. The all-pairs kernel beats the blocked
    XLA form at every size measured. The PM deposit/gather and the
    rasterizer have no kernel: they are XLA scatter-adds. ``interpret``
    passes through only as the caller gave it."""
    kernels = method == Method.PALLAS
    return Paths(step_kernel=kernels and substeps > 1,
                 pair_kernel=kernels, interpret=interpret)


class Engine:
    def __init__(
        self,
        particle_count: Optional[int] = None,
        method: Optional[Method] = None,
        generation_mode: SphereGeneration = SphereGeneration.HOLLOW,
        pairwise: Optional[PairwiseParams] = None,
        pm: Optional[PMConfig] = None,
        masses: Optional[np.ndarray] = None,
        interpret: bool = False,
        substeps: int = 1,
        debug_checks: bool = False,
        mesh=None,
        pm_persist: Optional[bool] = None,
        pm2=None,
        pmx=None,
        two_tier: bool = True,
    ):
        """``mesh``: a 1-D jax.sharding.Mesh (parallel.mesh.make_mesh) to
        row-shard the state over its ``dp`` axis — the multi-device mode.
        Attractor stepping is then zero-communication data parallelism;
        pairwise mode uses the ppermute ring (parallel/ring.py).

        ``pm``: solve the pairwise gravity with the O(N) particle-mesh
        solver (ops/pm*.py) instead of the direct O(N^2) sum; the traced
        G constant still comes from ``pairwise`` (defaulted if omitted),
        while the softening is pm.softening (static). The deposit and
        gather are XLA scatter/gather (ops/pm.py) for every method;
        multi-device uses the psum-grid step (parallel/pm_dp.py).

        ``pm2``: a pm2.PM2Config refinement window — two-level PM
        (ops/pm2.py): fine-softened forces inside the (possibly
        centroid-tracking) window, the coarse field elsewhere. Requires
        ``pm``. Composes with ``pm_persist``: BOTH levels then run on
        the segmented persistent order (ops/pm_persist.py accel_sorted
        docstring); that composition is also the multi-device pm2 path
        (with ``mesh``, pm2 requires pm_persist). A SEQUENCE of
        PM2Configs (outermost first) runs the MULTI-level nested
        solver: pm2.pmn_accel_ref (telescoping difference kernels) per
        frame by default, or every level on the k+1-class persistent
        order with ``pm_persist=True`` (pm_persist.accel_sorted_multi;
        also the multi-device pmn path).

        ``pm_persist``: run the PM solver on the persistent cell-ordered
        state (ops/pm_persist.py): particles stay in cell order between
        repairs; identity order (colors, streaming, checkpoints) is
        rebuilt lazily only when an output accessor needs it. Requires
        ``pm`` with a grid in pm_persist.SUPPORTED_GRIDS
        (32/64/128/256) and a static box (no auto_box). The default
        (None) is the per-frame path, except on a ``mesh`` with ``pm2``,
        where the persistent order is the only sharded refinement path;
        True raises if the config can't support it.

        ``pmx``: a pmx.PMXConfig — window-EXACT short-range forces
        (ops/pmx.py): member pairs of a tracked window nested inside
        the innermost mesh level feel the exact ``pmx.softening`` force
        via a real-space difference-kernel all-pairs pass. Requires
        ``pm``; composes with any ``pm2`` depth per-frame; with
        ``pm_persist=True`` it needs a MULTI-level ``pm2`` stack (the
        window rides the innermost class as one dynamic slice), and
        with ``mesh`` the member buffer is all-gathered across shards
        (pm_persist.accel_sorted_multi). The window's all-pairs passes
        run on the Triton kernel under Method.PALLAS (select_paths).

        ``two_tier``: repair strategy for the single-level persistent
        order — True (default) tries the segment-local grouping sort
        before the full sort; False repairs with the full sort only,
        for violent scenes whose bulk motion crosses segments
        (ops/pm_persist.py accel_sorted docstring). Ignored by
        multi-level stacks (always full k+1-class sort).

        ``masses``: f32[particle_count] per-particle SOURCE masses for
        the gravity solvers (heavy central bodies, multi-species scenes;
        the reference is unit-mass). Gravity is an acceleration field, so
        only sources are scaled. Grown particles get mass 1. With a
        ``mesh``, the mass array is row-sharded alongside the state
        (the ring rotates it with the position shards)."""
        self._interpret = interpret
        self.debug_checks = debug_checks
        self.mesh = mesh
        avail = available_methods(interpret)
        if method is None:
            method = avail[-1]  # best available (app.rs:106-125)
        if method not in avail:
            raise ValueError(
                f"method {method.name} unavailable on backend "
                f"{jax.default_backend()!r} (available: "
                f"{[m.name for m in avail]})")
        if particle_count is None:
            particle_count = (DEFAULT_COUNT_PALLAS if method == Method.PALLAS
                              else DEFAULT_COUNT_JNP)
        self.method = method
        self.generation_mode = generation_mode
        self.pm = pm
        if pm_persist:
            _check_persist_cfg(pm)
        if pm2 is not None:
            if pm is None:
                raise ValueError("pm2 requires a coarse PMConfig (pm=...)")
            # a sequence of PM2Configs = MULTI-level nesting: pmn_accel_ref
            # per frame, or the k+1-class persistent order with
            # pm_persist=True (pm_persist.accel_sorted_multi); normalize
            # a 1-tuple back to the plain two-level mode
            if isinstance(pm2, (tuple, list)):
                pm2 = tuple(pm2)
                if len(pm2) == 1:
                    pm2 = pm2[0]
            if mesh is not None:
                if pm_persist is None:
                    _check_persist_cfg(pm)
                    pm_persist = True   # the only sharded pm2 path
                if pm_persist is not True:
                    raise ValueError("multi-device pm2 requires pm_persist "
                                     "(parallel/pm_persist_dp.py is the "
                                     "sharded refinement path)")
        if pmx is not None:
            # window-EXACT short-range forces (ops/pmx.py): composing
            # with the pm2 stack — per-frame, or on the persistent
            # MULTI-level order (pm2 tuple + pm_persist=True, where the
            # contiguous innermost class makes the member buffer one
            # dynamic slice — accel_sorted_multi cfgx). Multi-device rides
            # the SAME order: each shard contributes capacity/n_dev
            # slots of its innermost class to one all_gather'd global
            # member buffer (parallel/pm_persist_dp.py cfgx).
            if pm is None:
                raise ValueError("pmx requires the PM solver (pm=...)")
            if mesh is not None:
                if not (isinstance(pm2, tuple) and pm_persist is True):
                    raise ValueError(
                        "multi-device pmx rides the persistent MULTI-"
                        "level class order — pass a tuple pm2 (which "
                        "resolves pm_persist=True on a mesh)")
                n_dev = int(mesh.devices.size)
                if pmx.capacity % (512 * n_dev):
                    raise ValueError(
                        f"pmx capacity {pmx.capacity} must be a "
                        f"multiple of 512 * {n_dev} mesh devices")
            if pm_persist is True and not (isinstance(pm2, (tuple, list))
                                           and len(pm2) > 1):
                raise ValueError(
                    "pmx + pm_persist needs a MULTI-level pm2 stack "
                    "(tuple) — the exact window rides the innermost "
                    "class of the k+1-class persistent order")
        self.pmx = pmx
        self._pmx_members = None       # (n_members, n_corrected) device
        self._pmx_check_at = 0         # next frame index to fetch them
        self._pmx_overflowing = False  # warn once per overflow episode
        self._frame_index = 0
        self.pm2 = pm2
        self.pm_persist = bool(pm_persist)
        # repair strategy for the single-level persistent order: True
        # tries the segment-local grouping sort first (tier 1, cheap for
        # gentle chunk-local drift), False goes straight to the full
        # sort every repair (ops/pm_persist.py accel_sorted docstring).
        # Multi-level stacks always repair via the full k+1-class sort.
        self.two_tier = bool(two_tier)
        self._persist = None          # SortedPMState / dp carry, lazy
        self._identity_dirty = False  # state planes stale vs _persist
        if pm is not None and pairwise is None:
            pairwise = PairwiseParams(1.0, pm.softening)
        self.pairwise = pairwise
        self.substeps = substeps
        self.paused = False
        self.stats = FrameStats()
        self._jit_cache: dict = {}
        self.state = self._generate_state(particle_count)
        self._masses = None
        if masses is not None:
            self.set_masses(masses)

    # -- construction helpers -------------------------------------------------
    @property
    def _row_multiple(self) -> int:
        if self.mesh is None:
            return 8
        return 8 * int(self.mesh.devices.size)

    def _shard(self, state: ParticleState) -> ParticleState:
        if self.mesh is None:
            return state
        from ..parallel import mesh as mesh_lib

        pos, vel, col = mesh_lib.shard_state_planes(
            self.mesh, state.pos, state.vel, state.init_color)
        return ParticleState(pos=pos, vel=vel, init_color=col,
                             n_active=state.n_active)

    def _generate_state(self, count: int,
                        capacity: Optional[int] = None) -> ParticleState:
        pos, vel, col = gen.generate(count, self.generation_mode)
        return self._shard(ParticleState.from_arrays(
            pos, vel, col, capacity=capacity,
            row_multiple=self._row_multiple))

    # -- properties -----------------------------------------------------------
    @property
    def state(self) -> "ParticleState":
        """Identity-order state planes. In persist mode the planes are
        rebuilt from the sorted carry transparently on FIRST read after
        a step (paid per consumed frame, never per simulated frame) —
        direct ``engine.state`` reads are never stale."""
        if self._identity_dirty:
            self.ensure_identity_order()
        return self._state

    @state.setter
    def state(self, value: "ParticleState") -> None:
        # externally assigned planes supersede any persistent carry
        self._state = value
        self._persist = None
        self._identity_dirty = False

    @property
    def particle_count(self) -> int:
        return int(self._state.n_active)

    @property
    def capacity(self) -> int:
        return self._state.capacity

    # -- masses -----------------------------------------------------------------
    @property
    def masses(self) -> Optional[jax.Array]:
        """f32[capacity] source masses, or None (unit masses)."""
        return self._masses

    def set_masses(self, masses) -> None:
        """Set per-particle source masses (length = particle_count)."""
        self.ensure_identity_order()
        self._persist = None  # sorted mass mirror is stale
        m = np.asarray(masses, dtype=np.float32).ravel()
        if m.shape[0] != self.particle_count:
            raise ValueError(
                f"masses length {m.shape[0]} != count {self.particle_count}")
        buf = np.ones((self.capacity,), np.float32)
        buf[: m.shape[0]] = m
        self._masses = self._place_masses(jnp.asarray(buf))

    def _place_masses(self, m: jax.Array) -> jax.Array:
        if self.mesh is None:
            return m
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.mesh import DP_AXIS

        return jax.device_put(
            m, NamedSharding(self.mesh, PartitionSpec(DP_AXIS)))

    def _masses_for_capacity(self) -> Optional[jax.Array]:
        """Masses padded/truncated to the CURRENT capacity (resize-safe)."""
        if self._masses is None:
            return None
        cap = self.capacity
        cur = self._masses.shape[0]
        if cur == cap:
            return self._masses
        if cur > cap:
            self._masses = self._place_masses(self._masses[:cap])
        else:
            self._masses = self._place_masses(jnp.concatenate(
                [self._masses, jnp.ones((cap - cur,), jnp.float32)]))
        return self._masses

    # -- stepping -------------------------------------------------------------
    @property
    def paths(self) -> Paths:
        """The kernels the current method and substeps run."""
        return select_paths(self.method, self.substeps, self._interpret)

    def _step_fn(self):
        paths = self.paths
        key = (paths, self.pairwise is not None, self.substeps,
               self.mesh is not None, self.pm, self._masses is not None,
               self.pm2, self.pmx)
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        substeps = self.substeps

        if self.pm is not None:
            fn = self._pm_step_fn(paths)
        elif self.mesh is not None:
            from ..parallel import dp, ring

            if self.pairwise is None:
                sharded = dp.make_sharded_step(
                    self.mesh, use_kernel=paths.step_kernel,
                    substeps=substeps, interpret=paths.interpret)

                def fn(pos, vel, pv, pp, n):
                    return sharded(pos, vel, pv)
            else:
                with_masses = self._masses is not None
                rstep = ring.make_ring_pairwise_step(
                    self.mesh, use_kernel=paths.pair_kernel,
                    interpret=paths.interpret, with_masses=with_masses)
                tail = ((lambda: (self._masses_for_capacity(),))
                        if with_masses else tuple)

                def fn(pos, vel, pv, pp, n):
                    for _ in range(substeps):
                        pos, vel = rstep(pos, vel, pv, pp, n, *tail())
                    return pos, vel
        elif self.pairwise is None:
            if paths.step_kernel:
                def fn(pos, vel, pv, pp, n):
                    return step_pallas.step_jit(
                        pos, vel, pv, substeps=substeps,
                        interpret=paths.interpret)
            else:
                def fn(pos, vel, pv, pp, n):
                    return step_jnp.step_n_jit(pos, vel, pv, substeps)
        else:
            if paths.pair_kernel:
                one = jax.jit(functools.partial(
                    pairwise_pallas.step_pairwise,
                    interpret=paths.interpret))
            else:
                one = jax.jit(pairwise_jnp.step_pairwise)

            def fn(pos, vel, pv, pp, n):
                for _ in range(substeps):
                    pos, vel = one(pos, vel, pv, pp, n,
                                   masses=self._masses_for_capacity())
                return pos, vel

        self._jit_cache[key] = fn
        return fn

    def _pm_step_fn(self, paths: Paths):
        """Per-frame PM step (the persistent order is _step_persist):
        coarse PM, optional refinement levels, optional exact window."""
        cfg, substeps = self.pm, self.substeps
        bk = self._base_kernels(cfg)
        if self.pmx is not None:
            from ..ops import pm2 as pm2_mod
            from ..ops import pmx as pmx_mod

            cfgx = self.pmx
            levels = (self.pm2 if isinstance(self.pm2, tuple)
                      else (self.pm2,) if self.pm2 is not None else ())
            kers = pm2_mod.levels_kernels(cfg, levels) if levels else None

            def fn(pos, vel, pv, pp, n):
                for _ in range(substeps):
                    pos, vel, n_m = pmx_mod.step_pmx_jit(
                        pos, vel, pv, pp, n, cfg, levels, cfgx,
                        use_kernel=paths.pair_kernel,
                        interpret=paths.interpret,
                        masses=self._masses_for_capacity(), kernels=kers,
                        base_kernels=bk)
                # device scalars, fetched lazily (pmx_member_count /
                # the periodic truncation check) — never a sync here
                self._pmx_members = (n_m, jnp.minimum(
                    n_m, jnp.int32(cfgx.capacity)))
                return pos, vel
            return fn

        if self.pm2 is not None:
            from ..ops import pm2 as pm2_mod

            cfg2 = self.pm2
            # fine kernels ride as jit arguments (device buffers), not
            # baked-in constants — see pm.diff_kernels_device
            if isinstance(cfg2, tuple):          # multi-level nesting
                kers = pm2_mod.levels_kernels(cfg, cfg2)
                step = functools.partial(pm2_mod.step_pmn_jit, levels=cfg2,
                                         kernels=kers)
            else:
                step = functools.partial(
                    pm2_mod.step_pm2_jit, cfg2=cfg2,
                    kernels=pm2_mod.fine_kernels(cfg, cfg2))

            def fn(pos, vel, pv, pp, n):
                for _ in range(substeps):
                    pos, vel = step(pos, vel, pv, pp, n, cfg=cfg,
                                    masses=self._masses_for_capacity(),
                                    base_kernels=bk)
                return pos, vel
            return fn

        if self.mesh is not None:
            from ..parallel import pm_dp

            with_masses = self._masses is not None
            pstep = pm_dp.make_pm_step(
                self.mesh, cfg, with_masses=with_masses,
                with_base_kernels=bk is not None)

            def one(pos, vel, pv, pp, n):
                tail = (self._masses_for_capacity(),) if with_masses else ()
                tail += (bk,) if bk is not None else ()
                return pstep(pos, vel, pv, pp, n, *tail)
        else:
            from ..ops import pm as pm_mod

            def one(pos, vel, pv, pp, n):
                return pm_mod.step_pm_jit(
                    pos, vel, pv, pp, n, cfg,
                    masses=self._masses_for_capacity(), kernels=bk)

        def fn(pos, vel, pv, pp, n):
            for _ in range(substeps):
                pos, vel = one(pos, vel, pv, pp, n)
            return pos, vel
        return fn

    # -- persistent cell-ordered PM mode (ops/pm_persist.py) -----------------
    def persist_resolved(self) -> bool:
        """Whether a step right now runs the persistent order:
        ``pm_persist`` set and the current PM config supports it (solver
        events may have swapped the PMConfig out from under it — fall
        back to the per-frame path gracefully)."""
        from ..ops import pm_persist as pper
        return (self.pm_persist and self.pm is not None
                and not self.pm.auto_box
                and self.pm.grid in pper.SUPPORTED_GRIDS)

    def _base_kernels(self, cfg):
        """Device-resident base solve kernels (pm.base_kernels_device)
        for STATIC-box configs — routed into the jitted steps as runtime
        arguments so the Hockney spectra never serialize into the
        program body. auto_box solves per-frame in cell units with
        traced scaling; its kernel is baked the classic way (small grids
        only)."""
        if cfg.auto_box:
            return None
        from ..ops import pm as pm_mod
        return pm_mod.base_kernels_device(cfg, cfg.softening)

    def _step_persist(self, pv, pp) -> None:
        from ..ops import pm as pm_mod
        from ..ops import pm_persist as pper
        cfg = self.pm
        paths = self.paths
        n_act = self._state.n_active
        masses = self._masses_for_capacity()
        # coarse Hockney kernels ride as runtime jit ARGUMENTS (device
        # pairs, cached) — see pm.base_kernels_device
        bk = pm_mod.base_kernels_device(cfg, cfg.softening)
        cfgx = self.pmx
        cfg2 = self.pm2
        ker = None
        if cfg2 is not None:
            from ..ops import pm2 as pm2_mod
            ker = (pm2_mod.levels_kernels(cfg, cfg2)
                   if isinstance(cfg2, tuple)
                   else pm2_mod.fine_kernels(cfg, cfg2))
        if self.mesh is not None:
            from ..parallel import pm_persist_dp
            n_levels = len(cfg2) if isinstance(cfg2, tuple) else 0
            key = ("persist_dp", cfg, cfg2, masses is not None,
                   self.substeps, paths, cfgx, self.two_tier)
            fns = self._jit_cache.get(key)
            if fns is None:
                fns = (pm_persist_dp.make_persist_init(
                           self.mesh, cfg, with_masses=masses is not None,
                           with_col=True, n_levels=n_levels),
                       pm_persist_dp.make_persist_pm_step(
                           self.mesh, cfg, use_kernel=paths.pair_kernel,
                           interpret=paths.interpret,
                           with_masses=masses is not None, with_col=True,
                           cfg2=cfg2, cfgx=cfgx,
                           two_tier=self.two_tier,
                           with_base_kernels=True))
                self._jit_cache[key] = fns
            init, pstep = fns
            if self._persist is None:
                col24 = raster.pack_col24(
                    self._state.init_color.reshape(3, -1))
                args = (self._state.pos.reshape(3, -1),
                        self._state.vel.reshape(3, -1), n_act)
                args += (masses,) if masses is not None else ()
                self._persist = init(*args + (col24,))
            tail = (ker,) if ker is not None else ()
            for _ in range(self.substeps):
                # carry = (pos, vel, ids, resorts, fine_b[, masses],
                # col24); the step takes masses/col24 AFTER (pv, pairv,
                # n_active) and the (replicated) fine kernels last
                c = self._persist
                out = pstep(*c[:5], pv, pp, n_act, *c[5:], *tail, bk)
                if cfgx is not None:
                    counts = out[-1]
                    self._persist = out[:-1]
                    self._pmx_members = (counts[0], counts[1])
                else:
                    self._persist = out
        else:
            if self._persist is None:
                init_kw = dict(
                    vel_flat=self._state.vel.reshape(3, -1), masses=masses,
                    col24=raster.pack_col24(
                        self._state.init_color.reshape(3, -1)))
                if isinstance(cfg2, tuple):
                    self._persist = pper.init_sorted_multi(
                        self._state.pos.reshape(3, -1), n_act, cfg,
                        len(cfg2), **init_kw)
                else:
                    self._persist = pper.init_sorted(
                        self._state.pos.reshape(3, -1), n_act, cfg,
                        **init_kw)
            for _ in range(self.substeps):
                out = pper.step_sorted_jit(
                    self._persist, pv, pp, n_act, cfg, cfg2=cfg2,
                    kernels=ker, base_kernels=bk, cfgx=cfgx,
                    two_tier=self.two_tier, use_kernel=paths.pair_kernel,
                    interpret=paths.interpret)
                if cfgx is not None:
                    self._persist, counts = out
                    self._pmx_members = (counts[0], counts[1])
                else:
                    self._persist = out
        self._identity_dirty = True

    def ensure_identity_order(self) -> None:
        """Rebuild the identity-order state planes from the persistent
        sorted state (no-op otherwise). Output accessors call this; the
        scatter is paid per CONSUMED frame, never per simulated frame."""
        if not self._identity_dirty:
            return
        from ..ops import pm_persist as pper
        carry = self._persist
        if self.mesh is None:
            st = carry
        else:
            st = pper.SortedPMState(carry[0], carry[1], carry[2], None,
                                    jnp.int32(0))
        key = ("persist_unsort",)
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = jax.jit(lambda s: pper.unsort(s, (s.pos, s.vel)))
            self._jit_cache[key] = fn
        pos_f, vel_f = fn(st)
        shape = self._state.pos.shape
        self._state = ParticleState(pos=pos_f.reshape(shape),
                                    vel=vel_f.reshape(shape),
                                    init_color=self._state.init_color,
                                    n_active=self._state.n_active)
        self._identity_dirty = False

    def _drop_persist(self) -> None:
        """Invalidate the sorted mirror (state about to be rebuilt)."""
        self._persist = None
        self._identity_dirty = False

    def step(self, params: Union[SimParams, np.ndarray]) -> None:
        """Advance one frame unless paused (app.rs:283). Dispatch is async."""
        self.stats.frame_tick()
        if self.paused:
            return
        pv = jnp.asarray(params.pack() if isinstance(params, SimParams)
                         else params)
        pp = jnp.asarray((self.pairwise or PairwiseParams()).pack())
        t0 = time.perf_counter()
        if self.persist_resolved():
            self._step_persist(pv, pp)
        else:
            self.ensure_identity_order()  # solver may have just switched
            self._persist = None
            pos, vel = self._step_fn()(self.state.pos, self.state.vel, pv,
                                       pp, self.state.n_active)
            self.state = ParticleState(pos=pos, vel=vel,
                                       init_color=self.state.init_color,
                                       n_active=self.state.n_active)
        self.stats.record_update(time.perf_counter() - t0)
        self._frame_index += 1
        if (self._pmx_members is not None
                and self._frame_index >= self._pmx_check_at):
            # loud truncation: members beyond the compact
            # budget silently keep the mesh-only force, so poll the
            # device counters every ~2 s of frames and log the episode.
            # The 2-scalar fetch syncs an already-completed step — the
            # async dispatch pipeline only stalls 1/120 frames.
            self._pmx_check_at = self._frame_index + 120
            n_mem, n_corr = (int(np.asarray(c))
                             for c in self._pmx_members)
            if n_mem > n_corr and not self._pmx_overflowing:
                self._pmx_overflowing = True
                logger.warning(
                    "pmx window overflow: %d members, only %d inside "
                    "the capacity-%d exact buffer — the rest keep the "
                    "mesh-only force (grow pmx capacity or shrink the "
                    "window)", n_mem, n_corr, self.pmx.capacity)
            elif n_mem <= n_corr:
                self._pmx_overflowing = False
        if self.debug_checks:
            from ..utils.debug import validate_state
            if self._identity_dirty:
                st = (self._persist if self.mesh is None
                      else self._persist[:2])
                p = st.pos if self.mesh is None else st[0]
                v = st.vel if self.mesh is None else st[1]
                validate_state(p.reshape(self._state.pos.shape),
                               v.reshape(self._state.vel.shape))
            else:
                validate_state(self._state.pos, self._state.vel)

    def step_synced(self, params: Union[SimParams, np.ndarray]) -> None:
        """step() + device sync, recording honest device time."""
        t0 = time.perf_counter()
        self.step(params)
        # in persist mode sync on the live carry — rebuilding identity
        # order is a consumer cost, not part of the frame
        if self._identity_dirty:
            carry = self._persist
            leaf = carry.pos if self.mesh is None else carry[0]
        else:
            leaf = self._state.pos
        jax.block_until_ready(leaf)
        self.stats.record_update(time.perf_counter() - t0, device=True)

    # -- lifecycle (reference trait surface, mod.rs:21-50) --------------------
    def set_paused(self, paused: bool) -> None:
        self.paused = paused

    def is_paused(self) -> bool:
        return self.paused

    def reset(self, generation_mode: Optional[SphereGeneration] = None) -> None:
        """Regenerate at current count, keeping capacity (cpu.rs:172-186)."""
        if generation_mode is not None:
            self.generation_mode = generation_mode
        self._drop_persist()
        self.state = self._generate_state(self.particle_count,
                                          capacity=self.capacity)

    def resize(self, new_count: int,
               generation_mode: Optional[SphereGeneration] = None) -> None:
        """Grow appends preserving state; shrink keeps capacity (§3.3)."""
        new_count = max(int(new_count), 1)  # app.rs:480 clamps to >=1
        self.ensure_identity_order()  # grow/shrink read the state planes
        self._persist = None          # capacity/count change: re-init
        if generation_mode is not None and generation_mode != self.generation_mode:
            self.generation_mode = generation_mode
            # generation-mode change regenerates (app.rs:479-491 passes the
            # new mode into resize_buffer; state distributions must match it)
            cap = max(self.capacity,
                      capacity_rows(new_count, self._row_multiple) * LANE)
            self.state = self._generate_state(new_count, capacity=cap)
            return
        old_count = self.particle_count
        if new_count == old_count:
            return
        if new_count <= self.capacity and new_count <= old_count:
            # shrink: keep buffer, adjust count (cpu.rs:132-150)
            self.state = ParticleState(
                pos=self.state.pos, vel=self.state.vel,
                init_color=self.state.init_color,
                n_active=jnp.asarray(new_count, jnp.int32))
            return
        # grow: append newly generated particles device-side — only the new
        # tail crosses to the device (cpu.rs:136-147 semantics).
        # Grown particles get mass 1, even where a past shrink left stale
        # custom masses in the (kept-capacity) buffer.
        if self._masses is not None:
            m = self._masses_for_capacity()
            self._masses = self._place_masses(
                m.at[old_count:new_count].set(1.0))
        add = new_count - old_count
        pos_a, vel_a, col_a = gen.generate(add, self.generation_mode)
        if self.mesh is not None:
            # sharded state: rebuild via host (rare path; keeps shardings)
            self.state = self._shard(ParticleState.from_arrays(
                np.concatenate([self.state.positions(), pos_a]),
                np.concatenate([self.state.velocities(), vel_a]),
                np.concatenate([self.state.init_colors_rgba()[:, :3], col_a]),
                row_multiple=self._row_multiple))
            return
        from ..core.state import grow_state
        self.state = grow_state(self.state, pos_a, vel_a, col_a, new_count)

    def set_pm2(self, pm2) -> None:
        """Swap the refinement stack at runtime (server 'solver' events):
        same normalization/validation as the constructor; the persistent
        carry is rebuilt on the next step (a tuple stack needs the
        k+1-class boundary vector, a single config the scalar one).

        Every invalid combination raises HERE, at the call site — never
        at trace time inside the frame loop (a single-level stack once
        skipped _validate_levels, and a swap incompatible with an
        installed ``pmx`` deferred its error to engine.step())."""
        if pm2 is not None and self.pm is None:
            raise ValueError("pm2 requires a PM solver (pm=...)")
        if isinstance(pm2, (tuple, list)):
            pm2 = tuple(pm2)
            if len(pm2) == 1:
                pm2 = pm2[0]
            elif len(pm2) == 0:
                pm2 = None
        if pm2 is not None:
            from ..ops import pm2 as pm2_mod
            # single configs get the same nesting/softening checks as
            # tuples (the difference split needs eps < coarse eps)
            pm2_mod._validate_levels(
                self.pm, pm2 if isinstance(pm2, tuple) else (pm2,))
        if self.mesh is not None and pm2 is not None \
                and self.pm_persist is not True:
            raise ValueError("multi-device pm2 requires pm_persist")
        if self.pmx is not None:
            # an installed exact window constrains the stack: persistent
            # mode needs the multi-level class order, and the window
            # must nest (softening/extent) inside the new innermost level
            from ..ops import pmx as pmx_mod
            if self.pm_persist is True and not (isinstance(pm2, tuple)
                                                and len(pm2) > 1):
                raise ValueError(
                    "pmx + pm_persist needs a MULTI-level pm2 stack "
                    "(tuple) — the exact window rides the innermost "
                    "class of the k+1-class persistent order")
            levels = (pm2 if isinstance(pm2, tuple)
                      else (pm2,) if pm2 is not None else ())
            pmx_mod._validate(self.pm, levels, self.pmx)
        if pm2 == self.pm2:
            return
        self.ensure_identity_order()
        self._persist = None
        self.pm2 = pm2

    def set_pmx(self, pmx) -> None:
        """Install / replace / clear the window-exact correction at
        runtime (server 'solver' events — the live-panel counterpart of
        the ``--pmx-size`` CLI flag). Validates the full combination at
        the call site, like set_pm2. The persistent carry is KEPT: the
        class order depends only on the pm2 stack, and the exact window
        rides it read-only (a new cfgx just compiles a new step)."""
        if pmx is not None:
            from ..ops import pmx as pmx_mod
            if self.pm is None:
                raise ValueError("pmx requires the PM solver (pm=...)")
            if self.mesh is not None:
                # mesh path needs the multi-level persistent order (the
                # gathered-window slice rides the innermost class)
                if not (isinstance(self.pm2, tuple)
                        and self.pm_persist is True):
                    raise ValueError(
                        "multi-device pmx needs a MULTI-level pm2 stack "
                        "(tuple) + pm_persist")
                n_dev = int(self.mesh.devices.size)
                if pmx.capacity % (512 * n_dev):
                    raise ValueError(
                        f"pmx capacity {pmx.capacity} must be a "
                        f"multiple of 512 * {n_dev} mesh devices")
            if self.pm_persist is True and not (
                    isinstance(self.pm2, tuple) and len(self.pm2) > 1):
                raise ValueError(
                    "pmx + pm_persist needs a MULTI-level pm2 stack "
                    "(tuple) — the exact window rides the innermost "
                    "class of the k+1-class persistent order")
            levels = (self.pm2 if isinstance(self.pm2, tuple)
                      else (self.pm2,) if self.pm2 is not None else ())
            pmx_mod._validate(self.pm, levels, pmx)
        if pmx == self.pmx:
            return
        self.pmx = pmx
        self._pmx_members = None   # stale count from the old window
        self._pmx_overflowing = False

    def set_method(self, method: Method) -> None:
        """Hot-swap backend: fresh state, count+pause preserved
        (app.rs:172-200 — the reference intentionally does not migrate)."""
        if method == self.method:
            return
        if method not in available_methods(self._interpret):
            raise ValueError(f"method {method.name} unavailable")
        count, was_paused = self.particle_count, self.paused
        self.method = method
        self._drop_persist()
        self.state = self._generate_state(count)
        self.paused = was_paused

    # -- diagnostics -----------------------------------------------------------
    def pmx_member_count(self):
        """(n_members, n_corrected) of the newest pmx frame, or None
        before the first step. n_corrected < n_members means the exact
        window overflowed its capacity (overflow keeps the mesh force —
        step() logs the episode; this is the on-demand readout for
        stats/UI surfaces). Fetches two device scalars."""
        if self._pmx_members is None:
            return None
        return tuple(int(np.asarray(c)) for c in self._pmx_members)

    def diagnostics(self, potential: bool = False):
        """Physics observables (ops/diagnostics.py): kinetic energy,
        momentum, mean radius, max speed; ``potential=True`` adds the
        gravitational potential (exact at small N, mesh estimate with a
        PM config at large N)."""
        from ..ops import diagnostics as diag

        self.ensure_identity_order()
        g = (self.pairwise.gravitational_constant if self.pairwise else 0.0)
        eps = (self.pm.softening if self.pm
               else self.pairwise.softening if self.pairwise else 2.0)
        return diag.measure(
            self.state.pos, self.state.vel, self.state.n_active,
            g_const=g, softening=eps, pm_cfg=self.pm, potential=potential,
            masses=self._masses_for_capacity())

    # -- output ---------------------------------------------------------------
    def colors_rgba(self, params: Union[SimParams, np.ndarray]) -> np.ndarray:
        """float32[n_active, 4] current colors (compute.wgsl:74-93)."""
        self.ensure_identity_order()
        pv = jnp.asarray(params.pack() if isinstance(params, SimParams)
                         else params)
        rgb = step_jnp.colors_jit(self.state.pos, self.state.vel,
                                  self.state.init_color, pv)
        n = self.particle_count
        out = np.ones((n, 4), dtype=np.float32)
        out[:, :3] = np.asarray(rgb.reshape(3, -1)[:, :n]).T
        return out

    def frame_arrays(
        self, params: Union[SimParams, np.ndarray], max_points: int = 0,
    ) -> tuple:
        """Host-side (pos f32[3, n], rgba u8[n, 4]) for the stream packer.

        rgba is premultiplied by the fragment brightness min(2|v|,1)
        (particle.wgsl:41-44) so thin clients just draw the color. When
        ``max_points`` > 0, returns a strided subsample, chosen device-side
        so only the subsample crosses to the host.
        """
        pos_dev, rgba_dev = self.frame_arrays_device(params, max_points)
        return np.asarray(pos_dev), np.asarray(rgba_dev)

    def frame_arrays_device(
        self, params: Union[SimParams, np.ndarray], max_points: int = 0,
    ) -> tuple:
        """Device-array variant of frame_arrays: dispatches the pack and
        returns without forcing the device->host transfer, so a caller can
        release locks before the (slow) fetch.

        In persist mode the pack is served straight from the SORTED
        planes when the state carries its display color (col24): point
        clouds are order-independent to draw, and a strided subsample of
        the cell-sorted order is spatially uniform. The subsample's
        MEMBERS can change when a repair reorders slots (rare; a brief
        shimmer at worst) — the alternative is a 135 ms identity un-sort
        per consumed frame at 16M."""
        pv = jnp.asarray(params.pack() if isinstance(params, SimParams)
                         else params)
        n = self.particle_count
        if (self._identity_dirty and self.mesh is None
                and self._persist is not None
                and self._persist.col24 is not None):
            shape = self._state.pos.shape
            src_pos = self._persist.pos.reshape(shape)
            src_vel = self._persist.vel.reshape(shape)
            src_col = (raster.unpack_col24(self._persist.col24)
                       .reshape(self._state.init_color.shape))
            # active slots are NOT a storage prefix guarantee for the
            # pack's ``arange < n_stop`` mask — dead slots sort to the
            # tail only at repairs — but between repairs slots do not
            # move and dead slots stay at the tail, so the prefix mask
            # holds for any state initialized at the current count
            # (resize/reset re-init the persist state).
        else:
            self.ensure_identity_order()
            src_pos, src_vel = self.state.pos, self.state.vel
            src_col = self.state.init_color
        stride = 1
        if max_points and n > max_points:
            stride = -(-n // max_points)
        pos_dev, rgba_dev = raster.pack_points_jit(
            src_pos, src_vel, src_col, pv, n_stop=n, stride=stride)
        # the pack strides the PADDED capacity; slice to the live range so
        # the payload honors max_points even when capacity >> n_active
        out_n = -(-max(n, 1) // stride)
        return pos_dev[:, :out_n], rgba_dev[:out_n]

    def render_frame_device(
        self, camera: Camera, params: Union[SimParams, np.ndarray],
        width: int = 1920, height: int = 1080,
    ):
        """Dispatch the headless rasterizer (render/raster.py, an XLA
        scatter-add blend); return the uint8[H, W, 4] frame as a DEVICE
        array (no host transfer forced — callers holding a lock can
        release it before the slow fetch; see server.py)."""
        from ..core.params import P_COLOR_MODE

        if isinstance(params, SimParams):
            cmode = int(params.color_mode)
            pv = jnp.asarray(params.pack())
        else:
            cmode = int(np.asarray(params)[P_COLOR_MODE])
            pv = jnp.asarray(params)
        if self.mesh is not None:
            return raster.to_rgba8(
                self._render_frame_dp(pv, camera, width, height))
        persist_ok = (self._identity_dirty and self._persist is not None
                      and (cmode != ColorMode.ORIGINAL
                           or self._persist.col24 is not None))
        if persist_ok:
            # The raster is order-independent (commutative additive
            # blend), so render straight from the persistent slot-order
            # planes and skip the identity un-sort entirely (active
            # slots are a storage prefix: dead keys are the sentinel so
            # every repair sorts them to the tail, and slots do not
            # move between repairs). Color mode 0 (ORIGINAL — the
            # reference default) pairs points with init_color; the
            # persist state carries it pre-paired as ``col24``
            # (SortedPMState docstring), so even the DEFAULT config
            # renders sort-free. Legacy col24-less states (old
            # checkpoints) keep the un-sort for mode 0 only.
            shape = self._state.pos.shape
            st_pos = self._persist.pos.reshape(shape)
            st_vel = self._persist.vel.reshape(shape)
            st_col = (raster.unpack_col24(self._persist.col24)
                      .reshape(self._state.init_color.shape)
                      if self._persist.col24 is not None
                      else self._state.init_color)
        else:
            self.ensure_identity_order()
            st_pos, st_vel = self._state.pos, self._state.vel
            st_col = self._state.init_color
        vp = jnp.asarray(camera.view_proj())
        fb = raster.render_jit(st_pos, st_vel, st_col, pv, vp,
                               self._state.n_active,
                               width=width, height=height)
        return raster.to_rgba8(fb)

    def _render_frame_dp(self, pv, camera: Camera, width: int, height: int):
        """Multi-device render: per-shard rasterization + one framebuffer
        psum (parallel/render_dp.py) — no particle gather, communication
        is resolution-bound. Returns the replicated f32 framebuffer. In
        persist mode it renders straight from the sharded slot-order
        carry (positions, velocities, carried col24 display color), so
        the multi-device frame never rebuilds identity order."""
        from ..parallel.render_dp import make_render_dp

        carry = self._persist if self._identity_dirty else None
        flat = carry is not None
        key = ("render_dp", width, height, flat)
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = make_render_dp(self.mesh, width=width, height=height,
                                flat=flat)
            self._jit_cache[key] = fn
        vp = jnp.asarray(camera.view_proj())
        if flat:
            # carry = (pos, vel, ids, resorts, fine_b[, masses], col24)
            return fn(carry[0], carry[1], raster.unpack_col24(carry[-1]),
                      pv, vp, self._state.n_active)
        st = self.state
        return fn(st.pos, st.vel, st.init_color, pv, vp, st.n_active)

    def render_frame(
        self, camera: Camera, params: Union[SimParams, np.ndarray],
        width: int = 1920, height: int = 1080,
    ) -> np.ndarray:
        """uint8[H, W, 4] frame via the headless rasterizer (host array)."""
        return np.asarray(self.render_frame_device(
            camera, params, width=width, height=height))
