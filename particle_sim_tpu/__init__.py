"""particle_sim_tpu — a 3D particle-simulation engine for GPUs.

A JAX/XLA/Pallas engine with the capabilities of
``lucascompython/particle-simulation-3d``, designed for an accelerator
rather than ported line by line. See SURVEY.md for the blueprint.
"""

from .core import (
    ColorMode,
    Method,
    PairwiseParams,
    PMConfig,
    ParticleState,
    SimParams,
    SphereGeneration,
    generate,
)
from .ops.pm2 import PM2Config
from .ops.pmx import PMXConfig

__version__ = "0.1.0"

__all__ = [
    "ColorMode",
    "PM2Config",
    "PMXConfig",
    "Method",
    "PairwiseParams",
    "PMConfig",
    "ParticleState",
    "SimParams",
    "SphereGeneration",
    "generate",
]
