"""Release/packaging tool — this engine's analog of the reference's
``release/`` xtask (``release/src/main.rs:31-55``: a CLI with
``--wasm --wasm-rayon --target --native --public-url --ci`` that produces
optimized deployable artifacts).

The reference ships a wasm web bundle (trunk + wasm-opt, hashed assets) and a
tuned native binary (``-C target-cpu=native``, LTO). This engine has
different artifacts but the same jobs:

  web bundle   ``--web``:   the thin-client viewer (index.html / sw.js /
               manifest.json) copied into ``<out>/web`` with ``--public-url``
               prefix rewriting (``release/src/main.rs:47-49`` analog) and a
               content-hash-stamped service-worker cache name (trunk's hashed
               asset names analog) so deployed clients pick up new versions.
  native lib   ``--native``: the C++ frame packer compiled into
               ``<out>/native`` (``build_native`` analog; ``--ci`` switches
               ``-march=native`` off for portable artifacts, mirroring the
               xtask's conditional target-cpu=native,
               ``release/src/main.rs:271-282``).
  kernel warm  ``--warm``:  precompile the jitted steppers for the requested
               capacity buckets into the program's persistent compile
               cache (utils/cache.py) — the deploy-time answer to the
               reference's "improve startup time" TODO (``README.md:47``);
               later runs on the same machine load executables from
               disk instead of compiling.
  AOT export   ``--aot``:   ``jax.export`` the step functions to versioned
               StableHLO artifacts in ``<out>/aot`` — a compiler-portable
               snapshot of the compute graph (the closest analog of
               shipping a compiled binary).

Everything lands under ``--out`` (default ``dist/``) plus a MANIFEST.json
with sha256s, mirroring trunk's hashed output listing.

Example:
    python -m particle_sim_tpu.app.release --out dist --web --native \
        --warm --counts 100000 1000000 --public-url /psim
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

_VIEWER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "viewer")
_WEB_ASSETS = ("index.html", "sw.js", "manifest.json")
_WEB_ICONS = ("icon-1024.png", "icon-256.png", "icon_ios_touch_192.png",
              "maskable_icon_x512.png", "favicon.png")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def _rewrite_public_url(text: str, public_url: str) -> str:
    """Prefix absolute asset/app paths with the deploy prefix.

    Analog of the xtask's ``--public-url`` pass-through to trunk
    (``release/src/main.rs:47-49,240-246``). The viewer references
    ``/manifest.json``, ``/sw.js``, ``/ws`` and caches ``/``.
    """
    pu = "/" + public_url.strip("/")
    if pu == "/":
        return text
    for path in ("/manifest.json", "/sw.js", "/ws"):
        text = text.replace(f'"{path}"', f'"{pu}{path}"')
        text = text.replace(f"`{path}`", f"`{pu}{path}`")
        # template-literal WebSocket URL: `ws://${location.host}/ws`
        text = text.replace(f"{{location.host}}{path}",
                            f"{{location.host}}{pu}{path}")
    text = text.replace('"start_url": "/"', f'"start_url": "{pu}/"')
    text = text.replace('ASSETS = ["/"', f'ASSETS = ["{pu}/"')
    return text


def build_web(out_dir: str, public_url: str = "/") -> list[str]:
    """Bundle the thin-client viewer (trunk-build analog)."""
    web = os.path.join(out_dir, "web")
    os.makedirs(web, exist_ok=True)
    texts = {}
    for name in _WEB_ASSETS:
        with open(os.path.join(_VIEWER_DIR, name), encoding="utf-8") as f:
            texts[name] = _rewrite_public_url(f.read(), public_url)
    # Stamp the SW cache name with a content hash of the whole bundle so a
    # redeploy invalidates stale caches (trunk's hashed-filename analog).
    bundle_hash = hashlib.sha256(
        "".join(texts[n] for n in _WEB_ASSETS).encode()).hexdigest()[:12]
    texts["sw.js"] = texts["sw.js"].replace(
        'const CACHE = "psim-tpu-v1";',
        f'const CACHE = "psim-tpu-{bundle_hash}";')
    written = []
    for name in _WEB_ASSETS:
        path = os.path.join(web, name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(texts[name])
        written.append(path)
    # install icons (reference index.html:26-50): copied verbatim
    assets_dir = os.path.join(web, "assets")
    os.makedirs(assets_dir, exist_ok=True)
    for name in _WEB_ICONS:
        src = os.path.join(_VIEWER_DIR, "assets", name)
        path = os.path.join(assets_dir, name)
        shutil.copyfile(src, path)
        written.append(path)
    return written


def build_native(out_dir: str, ci: bool = False) -> list[str]:
    """Compile the C++ frame packer (build_native analog).

    ``ci=True`` drops ``-march=native`` for a portable artifact, mirroring
    the xtask's conditional ``-C target-cpu=native``
    (``release/src/main.rs:271-282``).
    """
    from ..native.build import SRC
    nat = os.path.join(out_dir, "native")
    os.makedirs(nat, exist_ok=True)
    lib = os.path.join(nat, "libpsimpack.so")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    if not ci:
        cmd.append("-march=native")
    cmd += [SRC, "-o", lib]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return [lib]


def _step_fns_and_args(counts, methods):
    """(label, fn, example_args) for each (count, method) combo."""
    import jax.numpy as jnp

    from ..core import generate
    from ..core.params import Method, SimParams, SphereGeneration
    from ..core.state import ParticleState
    from ..engine.engine import available_methods
    from ..ops import step_jnp, step_pallas

    pv = jnp.asarray(SimParams(
        gravity=1.0, is_mouse_dragging=True,
        mouse_position=(0.0, 0.0, 48.0)).pack())
    out = []
    for n in counts:
        pos, vel, col = generate.generate(n, SphereGeneration.HOLLOW)
        st = ParticleState.from_arrays(pos, vel, col)
        for m in methods:
            if m not in available_methods():
                continue  # the Triton kernel compiles only for a GPU
            fn = (step_pallas.step if m == Method.PALLAS else step_jnp.step)
            out.append((f"step_{m.name.lower()}_n{n}", fn,
                        (st.pos, st.vel, pv)))
    return out


def warm_kernels(out_dir: str, counts) -> list[str]:
    """Precompile steppers into the program's persistent compile cache
    (utils/cache.py: JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache)
    so the first interactive frames skip compilation. The cache stays
    where every entry point looks for it; nothing lands in ``out_dir``."""
    import jax

    from ..core.params import Method
    from ..utils.cache import enable

    cache_dir = enable()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    for label, fn, args in _step_fns_and_args(
            counts, (Method.JNP, Method.PALLAS)):
        jax.block_until_ready(jax.jit(fn)(*args))
        print(f"  warmed {label} into {cache_dir}", file=sys.stderr)
    return []


def aot_export(out_dir: str, counts) -> list[str]:
    """Serialize step functions as versioned StableHLO via jax.export."""
    import jax
    from jax import export as jax_export

    from ..core.params import Method

    aot = os.path.join(out_dir, "aot")
    os.makedirs(aot, exist_ok=True)
    written = []
    for label, fn, args in _step_fns_and_args(counts, (Method.JNP,)):
        exported = jax_export.export(jax.jit(fn))(*args)
        path = os.path.join(aot, f"{label}.stablehlo.bin")
        with open(path, "wb") as f:
            f.write(exported.serialize())
        written.append(path)
    return written


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="particle_sim_tpu.release",
        description="Package deployable artifacts (xtask analog)")
    p.add_argument("--out", default="dist")
    p.add_argument("--web", action="store_true",
                   help="bundle the thin-client viewer (--wasm analog)")
    p.add_argument("--public-url", default="/",
                   help="deploy path prefix for web assets")
    p.add_argument("--native", action="store_true",
                   help="compile the C++ frame packer (--native analog)")
    p.add_argument("--warm", action="store_true",
                   help="precompile the steppers into the compile cache "
                   "(JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache)")
    p.add_argument("--aot", action="store_true",
                   help="jax.export step functions to <out>/aot")
    p.add_argument("--counts", type=int, nargs="+",
                   default=[100_000, 1_000_000],
                   help="capacity buckets to precompile (--target analog)")
    p.add_argument("--ci", action="store_true",
                   help="portable artifacts: no -march=native (--ci analog)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.web or args.native or args.warm or args.aot):
        args.web = args.native = True  # default artifact set
    os.makedirs(args.out, exist_ok=True)

    artifacts: list[str] = []
    t0 = time.perf_counter()
    if args.web:
        artifacts += build_web(args.out, args.public_url)
    if args.native:
        artifacts += build_native(args.out, ci=args.ci)
    if args.warm:
        artifacts += warm_kernels(args.out, args.counts)
    if args.aot:
        artifacts += aot_export(args.out, args.counts)

    from .. import __version__
    manifest = {
        "version": __version__,
        "public_url": args.public_url,
        "ci": args.ci,
        "artifacts": {
            os.path.relpath(p, args.out): (
                _sha256(p) if os.path.isfile(p) else "dir")
            for p in artifacts
        },
    }
    with open(os.path.join(args.out, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps({
        "out": args.out, "artifacts": len(artifacts),
        "wall_s": round(time.perf_counter() - t0, 2),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
