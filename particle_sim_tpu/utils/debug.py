"""Debug / validation mode — race-detection & sanitizer analog (SURVEY.md §5).

The reference's safety story is Rust's type system plus kernels that are
race-free by construction (one invocation per particle); it explicitly
disables GPU-side runtime checks in release (``app.rs:127-132``,
``compute.rs:45-50``). The analog of "debug build checks" here:

  * ``validate_state`` — device-side finiteness/bounds reduction over the
    state planes, raised to the host as an exception with which plane failed.
  * ``checked_step`` — wraps any stepper with jax.experimental.checkify to
    surface NaN/div-by-zero inside jitted code.
  * Pallas kernels all accept ``interpret=True`` (the kernel-debugger path).

Engine(debug_checks=True) runs validate_state after every step.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import checkify


class StateValidationError(RuntimeError):
    pass


@jax.jit
def _finite_report(pos, vel):
    return (jnp.isfinite(pos).all(), jnp.isfinite(vel).all(),
            jnp.abs(pos).max(), jnp.abs(vel).max())


def validate_state(pos, vel, *, max_abs_pos: float = 1e6,
                   max_abs_vel: float = 1e6) -> None:
    """Raise StateValidationError on NaN/Inf or runaway magnitudes."""
    pos_ok, vel_ok, pos_max, vel_max = (
        bool(x) if i < 2 else float(x)
        for i, x in enumerate(_finite_report(pos, vel)))
    problems = []
    if not pos_ok:
        problems.append("non-finite positions")
    if not vel_ok:
        problems.append("non-finite velocities")
    if pos_max > max_abs_pos:
        problems.append(f"position magnitude {pos_max:.3g} > {max_abs_pos:g}")
    if vel_max > max_abs_vel:
        problems.append(f"velocity magnitude {vel_max:.3g} > {max_abs_vel:g}")
    if problems:
        raise StateValidationError("; ".join(problems))


def checked_step(step_fn):
    """Wrap a traceable stepper with checkify float-error checks.

    Returns ``fn(*args) -> (error, out)``; call ``error.throw()`` to raise
    on NaN/inf produced anywhere inside the jitted computation.
    """
    checked = checkify.checkify(step_fn, errors=checkify.float_checks)
    return jax.jit(checked)
