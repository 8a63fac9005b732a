"""Simulation parameters and enums.

Mirrors the reference's parameter surface exactly:
  - ``SimParams`` replicates the 48-byte uniform POD of
    ``/root/reference/src/simulation/mod.rs:52-84`` (field set and defaults:
    delta_time=0.016, gravity=0.0, color_mode=0, mouse_force=5.0,
    mouse_radius=10.0, is_mouse_dragging=false, damping=0.99,
    max_dist_for_color=50.0, mouse_position=(0,0,0)).
  - ``ColorMode`` replicates the 0/1/2 color switch of
    ``/root/reference/src/shaders/compute.wgsl:74-93``.
  - ``SphereGeneration`` replicates ``mod.rs:16-19``.
  - ``Method`` replicates ``SimulationMethod`` (``mod.rs:10-13``): the
    reference's CPU (rayon) backend maps to the jitted jax.numpy reference
    stepper; its compute-shader backend maps to the fused Pallas kernel.

Design note: instead of a 48-byte uniform buffer, parameters travel
into jitted steppers as ONE packed ``float32[PARAM_VEC_SIZE]`` device vector
(``SimParams.pack()``). Every field is a *traced* scalar, so interactive
per-frame parameter changes (mouse drag, sliders — ``app.rs:290-301``) never
trigger recompilation; only shape (capacity) changes do.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np

# Indices into the packed parameter vector. Keep in sync with SimParams.pack()
# and with the indices the attractor kernel reads (ops/step_pallas.py).
P_DT = 0
P_GRAVITY = 1
P_MOUSE_FORCE = 2
P_MOUSE_RADIUS = 3
P_DAMPING = 4
P_MAX_DIST = 5
P_MOUSE_X = 6
P_MOUSE_Y = 7
P_MOUSE_Z = 8
P_DRAGGING = 9  # 0.0 / 1.0
P_COLOR_MODE = 10  # 0.0 / 1.0 / 2.0 (compared against 0.5 / 1.5 thresholds)
PARAM_VEC_SIZE = 16  # padded for alignment / future fields

#: Initial sphere radius — ``mod.rs:147`` (`sphere_radius = 50.0`).
SPHERE_RADIUS = 50.0

#: Fixed RNG seed of the Filled generator — ``mod.rs:170`` (SmallRng seed 69).
FILLED_SEED = 69


class ColorMode(enum.IntEnum):
    """Color switch of ``compute.wgsl:74-93`` / ``cpu.rs:93-107``."""

    ORIGINAL = 0   # color = initial_color
    VELOCITY = 1   # s=clamp(|v|/5,0,1) -> (s, 0.5-0.5s, 1-s, 1)
    POSITION = 2   # d=clamp(|p|/max(max_dist,0.01),0,1) -> (d, 0, 1-d, 1)


class SphereGeneration(enum.IntEnum):
    """``SphereGeneration`` enum of ``mod.rs:16-19``."""

    HOLLOW = 0
    FILLED = 1


class Method(enum.IntEnum):
    """Backend selector mirroring ``SimulationMethod`` (``mod.rs:10-13``).

    JNP    — jitted jax.numpy stepper (parity oracle; reference "Cpu" analog).
    PALLAS — hand-written Pallas kernels on the Triton route (reference
             "ComputeShader" analog; engine.select_paths picks which run).
    """

    JNP = 0
    PALLAS = 1


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Per-step simulation parameters (defaults from ``mod.rs:69-84``)."""

    delta_time: float = 0.016
    gravity: float = 0.0
    color_mode: int = int(ColorMode.ORIGINAL)
    mouse_force: float = 5.0
    mouse_radius: float = 10.0
    is_mouse_dragging: bool = False
    damping: float = 0.99
    max_dist_for_color: float = 50.0
    mouse_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def pack(self) -> np.ndarray:
        """Pack into the float32 parameter vector fed to jitted steppers."""
        v = np.zeros((PARAM_VEC_SIZE,), dtype=np.float32)
        v[P_DT] = self.delta_time
        v[P_GRAVITY] = self.gravity
        v[P_MOUSE_FORCE] = self.mouse_force
        v[P_MOUSE_RADIUS] = self.mouse_radius
        v[P_DAMPING] = self.damping
        v[P_MAX_DIST] = self.max_dist_for_color
        v[P_MOUSE_X : P_MOUSE_Z + 1] = self.mouse_position
        v[P_DRAGGING] = 1.0 if self.is_mouse_dragging else 0.0
        v[P_COLOR_MODE] = float(self.color_mode)
        return v

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PMConfig:
    """Particle-mesh solver configuration (ops/pm.py).

    PM solves the same softened gravity as PairwiseParams' direct sum, at
    O(N + G^3 log G): CIC deposit -> FFT Poisson -> CIC gather. All fields
    are STATIC (they shape grids and the cached Green's-function FFTs);
    the per-step traced scalar (G_const) stays in PairwiseParams.pack().

    grid:      cells per axis (any size per frame; the persistent
               cell-ordered mode supports pm_persist.SUPPORTED_GRIDS =
               32/64/128/256).
    box_min:   world coords of the grid origin.
    box_size:  world extent per axis; cell size h = box_size/grid. Default
               box spans [-64, 64)^3 around the radius-50 generation sphere
               (core/params.py SPHERE_RADIUS) with margin, h = 1.
    softening: Plummer eps (static here — baked into the kernel FFT —
               unlike PairwiseParams.softening which is traced). Resolve
               eps >= ~2h or short-range forces fall below mesh resolution.
    boundary:  'isolated' (vacuum, Hockney doubled-grid — parity with the
               direct sum) or 'periodic' (closed-form Fourier kernel,
               ~8x cheaper FFTs, periodic images).
    gradient:  'exact' (three inverse vector-kernel FFTs) or 'fd' (one
               potential FFT + central differences).
    auto_box:  True -> ignore box_min/box_size and track the live cloud
               with a traced cubic box every step (auto-zoom: resolution
               follows a collapsing/drifting cloud). ``softening`` is then
               in CELL units (the physical eps = softening * cell_size
               shrinks as the cloud does — adaptive softening), because
               the cached kernel FFTs must be box-independent. Caveat:
               adaptive softening changes the energy budget through deep
               collapses (the well deepens as the box zooms in, so cores
               can sling-shot) — use the static box (and a dt resolving
               eps/max_speed) for strict energy studies.
    """

    grid: int = 128
    box_min: Tuple[float, float, float] = (-64.0, -64.0, -64.0)
    box_size: float = 128.0
    softening: float = 2.0
    boundary: str = "isolated"
    gradient: str = "exact"
    auto_box: bool = False

    @property
    def cell_size(self) -> float:
        return self.box_size / self.grid


@dataclasses.dataclass(frozen=True)
class PairwiseParams:
    """Parameters of the all-pairs O(N^2) interaction extension.

    The reference's only force field is the 1-body mouse attractor
    (``compute.wgsl:56-66``); all-pairs gravity generalizes it.
    Softened monopole attraction with unit masses:

        a_i = G * sum_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^(3/2)

    The softening makes the self-pair contribute exactly zero (numerator 0),
    so no self-interaction mask is needed.
    """

    gravitational_constant: float = 1.0
    softening: float = 0.5

    def pack(self) -> np.ndarray:
        return np.array(
            [self.gravitational_constant, self.softening], dtype=np.float32
        )
