"""Path selection, the compile-cache location and chip_smoke.py's contract.

No engine path may run a kernel in the Pallas interpreter unless its caller
passed ``interpret=True``; the compile cache lives where
``JAX_COMPILATION_CACHE_DIR`` says, else at one fixed path in the checkout;
chip_smoke.py refuses to report anything without a GPU.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle_sim_tpu.core.params import (
    Method, PairwiseParams, PMConfig, SimParams,
)
from particle_sim_tpu.engine import engine as engine_mod
from particle_sim_tpu.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# path selection
# --------------------------------------------------------------------------

def _pallas_eqns(jaxpr):
    """Every pallas_call equation in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _pallas_eqns(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _pallas_eqns(sub)
    return out


def _traced_kernels(engine):
    """pallas_call equations of one traced engine frame (nothing runs)."""
    st = engine.state
    pv = jnp.asarray(SimParams(gravity=1.0).pack())
    pp = jnp.asarray((engine.pairwise or PairwiseParams()).pack())
    fn = engine._step_fn()
    jaxpr = jax.make_jaxpr(fn)(st.pos, st.vel, pv, pp, st.n_active)
    return _pallas_eqns(jaxpr.jaxpr)


@pytest.fixture
def fake_gpu(monkeypatch):
    """Make the engine see a GPU backend (tracing only; nothing compiles)."""
    monkeypatch.setattr(engine_mod.jax, "default_backend", lambda: "gpu")


@pytest.mark.parametrize("method,substeps,step,pair", [
    (Method.JNP, 1, False, False),
    (Method.JNP, 8, False, False),
    (Method.PALLAS, 1, False, True),    # interactive frame: XLA attractor
    (Method.PALLAS, 8, True, True),     # batch: the fused kernel
])
def test_select_paths(method, substeps, step, pair):
    p = engine_mod.select_paths(method, substeps)
    assert (p.step_kernel, p.pair_kernel, p.interpret) == (step, pair, False)
    assert engine_mod.select_paths(method, substeps, True).interpret


def test_cpu_offers_no_kernels_without_interpret():
    assert engine_mod.available_methods() == [Method.JNP]
    assert Method.PALLAS in engine_mod.available_methods(interpret=True)
    e = Engine(particle_count=None)
    assert e.method == Method.JNP
    assert e.particle_count == engine_mod.DEFAULT_COUNT_JNP
    with pytest.raises(ValueError, match="unavailable"):
        Engine(particle_count=1000, method=Method.PALLAS)


def test_gpu_defaults_to_kernels_at_1m(fake_gpu, monkeypatch):
    # no state is built at 1M on a CPU: only the chosen defaults matter
    seen = {}
    monkeypatch.setattr(Engine, "_generate_state",
                        lambda self, count, capacity=None:
                        seen.setdefault("count", count))
    e = Engine()
    assert e.method == Method.PALLAS
    assert seen["count"] == engine_mod.DEFAULT_COUNT_PALLAS == 1_000_000
    assert not e.paths.interpret


@pytest.mark.parametrize("mode", ["attractor_batch", "pairwise", "pmx"])
def test_engine_never_interprets_unasked(fake_gpu, mode):
    """A GPU engine built without interpret=True traces every kernel with
    interpret=False; the same engine built with interpret=True traces
    them all interpreted. Each mode must run at least one kernel."""
    from particle_sim_tpu.ops import pm2, pmx

    kw = dict(particle_count=2048, method=Method.PALLAS)
    if mode == "attractor_batch":
        kw.update(substeps=4)
    elif mode == "pairwise":
        kw.update(pairwise=PairwiseParams(1.0, 0.5))
    else:
        kw.update(pm=PMConfig(grid=32, softening=4.0),
                  pm2=(pm2.PM2Config(None, 32.0, softening=1.0),),
                  pmx=pmx.PMXConfig(window_size=8.0, softening=0.3,
                                    capacity=512))
    for interpret in (False, True):
        e = Engine(interpret=interpret, **kw)
        eqns = _traced_kernels(e)
        assert eqns, mode
        assert all(q.params["backend"] == "triton" for q in eqns)
        assert all(bool(q.params["interpret"]) == interpret for q in eqns)


def test_interactive_frame_runs_no_kernel(fake_gpu):
    # substeps=1 attractor: XLA's fusion of step_jnp (PERF.md)
    e = Engine(particle_count=2048, method=Method.PALLAS)
    assert _traced_kernels(e) == []


# --------------------------------------------------------------------------
# compile cache placement
# --------------------------------------------------------------------------

@pytest.fixture
def cache_config():
    """Restore JAX's cache settings after a test changes them."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_env_var_wins(monkeypatch, tmp_path, cache_config):
    from particle_sim_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cache.enable() == str(tmp_path / "env")
    # the env var is JAX's own setting: nothing here sets another dir,
    # and nothing creates the fixed in-checkout one
    assert jax.config.jax_compilation_cache_dir is None
    assert cache.cache_dir() == str(tmp_path / "env")


def test_cache_default_is_fixed_in_checkout(monkeypatch, tmp_path,
                                            cache_config):
    from particle_sim_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / ".jax_cache"))
    assert cache.enable() == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(
        tmp_path / ".jax_cache")
    assert os.path.isdir(tmp_path / ".jax_cache")


def test_cache_default_path_is_the_ignored_checkout_dir(monkeypatch):
    from particle_sim_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --------------------------------------------------------------------------
# chip_smoke.py
# --------------------------------------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_final_line():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = _smoke().final_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_smoke_refuses_cpu(capsys):
    smoke = _smoke()
    with pytest.raises(smoke.SmokeFailure, match="no GPU"):
        smoke.require_gpu(jax.devices())
    with pytest.raises(smoke.SmokeFailure):
        smoke.require_gpu([])
    rc = smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out


def test_smoke_png_reader(tmp_path):
    from particle_sim_tpu.utils.png import write_png

    img = (np.random.default_rng(1).random((7, 9, 3)) * 255).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(_smoke().read_png(str(tmp_path / "a.png")),
                                  img)
