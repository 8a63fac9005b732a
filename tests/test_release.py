"""Release/packaging tool tests (xtask analog — release/src/main.rs)."""

import json
import os
import subprocess

import pytest

from particle_sim_tpu.app import release


def test_web_bundle_default_url(tmp_path):
    out = str(tmp_path / "dist")
    written = release.build_web(out)
    names = {os.path.basename(p) for p in written}
    assert names == {"index.html", "sw.js", "manifest.json",
                     "icon-1024.png", "icon-256.png",
                     "icon_ios_touch_192.png", "maskable_icon_x512.png",
                     "favicon.png"}
    sw = (tmp_path / "dist" / "web" / "sw.js").read_text()
    # cache name stamped with a content hash, not the dev default
    assert 'const CACHE = "psim-tpu-v1"' not in sw
    assert 'const CACHE = "psim-tpu-' in sw


def test_web_bundle_public_url_rewrite(tmp_path):
    out = str(tmp_path / "dist")
    release.build_web(out, public_url="/psim")
    html = (tmp_path / "dist" / "web" / "index.html").read_text()
    assert '"/psim/manifest.json"' in html
    assert 'register("/psim/sw.js")' in html
    assert "{location.host}/psim/ws" in html
    mani = json.loads((tmp_path / "dist" / "web" / "manifest.json")
                      .read_text())
    assert mani["start_url"] == "/psim/"
    sw = (tmp_path / "dist" / "web" / "sw.js").read_text()
    assert '"/psim/"' in sw and '"/psim/manifest.json"' in sw


def test_native_build_and_manifest(tmp_path):
    try:
        subprocess.run(["g++", "--version"], capture_output=True, check=True)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no g++ toolchain")
    out = str(tmp_path / "dist")
    rc = release.main(["--out", out, "--web", "--native", "--ci"])
    assert rc == 0
    lib = os.path.join(out, "native", "libpsimpack.so")
    assert os.path.exists(lib)
    manifest = json.loads(open(os.path.join(out, "MANIFEST.json")).read())
    assert "native/libpsimpack.so" in manifest["artifacts"]
    assert manifest["ci"] is True
    assert len(manifest["artifacts"]["native/libpsimpack.so"]) == 64


def test_aot_export_cpu(tmp_path):
    out = str(tmp_path / "dist")
    paths = release.aot_export(out, counts=[1024])
    assert len(paths) == 1
    assert os.path.getsize(paths[0]) > 1000
    # round-trip: the serialized artifact deserializes and calls
    import jax
    from jax import export as jax_export

    from particle_sim_tpu.app.release import _step_fns_and_args
    from particle_sim_tpu.core.params import Method

    with open(paths[0], "rb") as f:
        exported = jax_export.deserialize(f.read())
    (_, _, args), = _step_fns_and_args([1024], (Method.JNP,))
    pos, vel = exported.call(*args)
    assert pos.shape == args[0].shape
    jax.block_until_ready((pos, vel))


def test_warm_kernels_cpu(tmp_path):
    # fresh interpreter: the persistent-cache dir binds at first use, so an
    # in-process run after other tests may silently keep their dir
    import subprocess
    import sys

    out = str(tmp_path / "dist")
    cache = str(tmp_path / "cache")
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from particle_sim_tpu.app import release\n"
        f"release.warm_kernels({out!r}, counts=[1024])\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=cache)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    # the cache is written where the variable says, and nowhere else
    assert any(os.scandir(cache)), "empty XLA cache after warm"
    assert not os.path.exists(os.path.join(out, "xla-cache"))
