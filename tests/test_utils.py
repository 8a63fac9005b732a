"""Debug/validation and profiling utilities."""

import numpy as np
import pytest

import jax.numpy as jnp

from particle_sim_tpu.core.params import Method, SimParams
from particle_sim_tpu.engine import Engine
from particle_sim_tpu.ops import step_jnp
from particle_sim_tpu.utils import debug, profiling


class TestValidate:
    def test_clean_state_passes(self):
        e = Engine(particle_count=500, method=Method.JNP)
        debug.validate_state(e.state.pos, e.state.vel)

    def test_nan_detected(self):
        pos = jnp.full((3, 8, 128), jnp.nan)
        vel = jnp.zeros((3, 8, 128))
        with pytest.raises(debug.StateValidationError, match="positions"):
            debug.validate_state(pos, vel)

    def test_runaway_detected(self):
        pos = jnp.zeros((3, 8, 128))
        vel = jnp.full((3, 8, 128), 1e9)
        with pytest.raises(debug.StateValidationError, match="velocity"):
            debug.validate_state(pos, vel)

    def test_engine_debug_mode(self):
        e = Engine(particle_count=200, method=Method.JNP, debug_checks=True)
        e.step(SimParams(gravity=1.0))  # clean step passes
        # poison the state, next step must raise
        e.state = e.state.__class__(
            pos=e.state.pos.at[0, 0, 0].set(jnp.nan), vel=e.state.vel,
            init_color=e.state.init_color, n_active=e.state.n_active)
        with pytest.raises(debug.StateValidationError):
            e.step(SimParams())


class TestCheckify:
    def test_checked_step_flags_nan(self):
        def bad_step(x):
            return x / (x - x)  # 0/0

        fn = debug.checked_step(bad_step)
        err, _ = fn(jnp.ones((4,)))
        with pytest.raises(Exception):
            err.throw()

    def test_checked_step_clean(self):
        pv = jnp.asarray(SimParams(gravity=1.0).pack())
        fn = debug.checked_step(lambda p, v: step_jnp.step(p, v, pv))
        pos = jnp.zeros((3, 8, 128))
        vel = jnp.ones((3, 8, 128))
        err, (p2, v2) = fn(pos, vel)
        err.throw()  # no error
        assert np.isfinite(np.asarray(p2)).all()


class TestProfiling:
    def test_device_time_and_marginal(self):
        pv = jnp.asarray(SimParams(gravity=1.0).pack())
        pos = jnp.zeros((3, 8, 128))
        vel = jnp.ones((3, 8, 128))

        def run_n(n):
            return step_jnp.step_n_jit(jnp.array(pos), jnp.array(vel), pv, n)

        t, out = profiling.device_time(lambda: run_n(4))
        assert t > 0 and out is not None
        m = profiling.marginal_time(run_n, 2, 12)
        assert m > 0

    @pytest.mark.slow
    def test_trace_writes_files(self, tmp_path):
        with profiling.trace(str(tmp_path)):
            profiling.sync(step_jnp.step_jit(
                jnp.zeros((3, 8, 128)), jnp.ones((3, 8, 128)),
                jnp.asarray(SimParams().pack())))
        files = list(tmp_path.rglob("*"))
        assert files  # trace artifacts written


class TestBinSearch:
    def test_matches_searchsorted(self):
        import jax.numpy as jnp
        from particle_sim_tpu.utils.search import bin_search

        rng = np.random.default_rng(0)
        arr = np.sort(rng.integers(0, 1000, 513)).astype(np.int32)
        probes = np.concatenate([
            rng.integers(-5, 1005, 257),
            arr[::7],            # exact hits
            [-1, 0, 999, 1000, 2000],  # beyond-the-ends probes
        ]).astype(np.int32)
        n_iters = max(len(arr), 2).bit_length() + 1
        for side, right in (("left", False), ("right", True)):
            got = np.asarray(bin_search(jnp.asarray(arr),
                                        jnp.asarray(probes), right, n_iters))
            want = np.searchsorted(arr, probes, side=side)
            np.testing.assert_array_equal(got, want)

    def test_extra_iterations_stay_converged(self):
        """Regression: probes beyond every element used to overshoot past
        n by one per extra iteration (double chunk-table rows)."""
        import jax.numpy as jnp
        from particle_sim_tpu.utils.search import bin_search

        arr = jnp.asarray(np.arange(100, dtype=np.int32))
        probes = jnp.asarray(np.int32([500, 99, 100]))
        got = np.asarray(bin_search(arr, probes, False, n_iters=40))
        np.testing.assert_array_equal(got, [100, 99, 100])
