"""End-to-end check that the engine runs compiled on one GPU.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # only the multi-device phase

Phases, each printing one JSON line with its timing and results:

  0. device: JAX must find a GPU (else exit 2, nothing else runs); the
     card's ``name, power.limit`` as nvidia-smi reports it.
  1. cli: ``particle_sim_tpu.app.cli`` at the reference's 1M particles,
     300 steps with the attractor on an orbit, color mode 1, a PNG every
     100 steps; checks the stats lines, finite state, non-black PNGs, and
     that the engine chose Method.PALLAS with no kernel interpreted.
  2. server: the stream server at 1M on a thread of this process (one
     process per card); a websocket client decodes frames in raster mode
     and in the f16 point mode.
  3. gravity: the CLI with --pm at 1M (G=128), --pm-persist at 4M,
     --pairwise at 65,536, and the pm2 + pmx exact-window stack.
  4. parity: every kernel and XLA path against its plain reference at
     real widths (particle_sim_tpu/utils/parity.py states each
     tolerance and its reason).
  5. --four-cards: dp attractor, ring all-pairs, psum-grid PM, persistent
     PM and the framebuffer-psum render on a flat 1-D mesh over four
     cards, each against its single-device result. No other phase runs.

Any failure raises and exits non-zero. Only a full pass prints the last
line: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def final_line(devices) -> str:
    """The last line of a passing run: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def require_gpu(devices) -> None:
    """Refuse to run anywhere but a GPU: no CPU carry-on."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "nothing"
        raise SmokeFailure(f"no GPU: JAX found {found!r}")


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t0, 3),
                      **fields}), flush=True)


def read_png(path: str) -> np.ndarray:
    """uint8[H, W, C] from the filter-0 PNGs utils/png.py writes."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h, ch = 8, b"", 0, 0, 3
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
            ch = 4 if ctype == 6 else 3
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, 1 + w * ch)[:, 1:].reshape(h, w, ch)


def run_cli(argv) -> tuple:
    """(engine, stdout lines) of one in-process CLI run."""
    from particle_sim_tpu.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        engine = cli.run(argv)
    return engine, [json.loads(x) for x in buf.getvalue().splitlines()
                    if x.startswith("{")]


def check_engine(engine, name: str) -> None:
    import jax
    from particle_sim_tpu.core.params import Method

    check(engine.method == Method.PALLAS,
          f"{name}: engine chose {engine.method.name}, not PALLAS")
    check(not engine.paths.interpret, f"{name}: a kernel is interpreted")
    if engine._persist is not None:
        check(bool(np.isfinite(np.asarray(jax.device_get(
            engine._persist.pos))).all()), f"{name}: non-finite state")
    else:
        check(bool(np.isfinite(np.asarray(engine.state.pos)).all()),
              f"{name}: non-finite state")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_cli(tmp: str) -> None:
    t0 = time.perf_counter()
    frames = os.path.join(tmp, "frames")
    engine, lines = run_cli([
        "--count", "1000000", "--steps", "300", "--drag", "--orbit-mouse",
        "--color-mode", "1", "--render-every", "100",
        "--render-dir", frames, "--stats-every", "100"])
    check_engine(engine, "cli")
    stats = [x for x in lines if "step" in x]
    check(len(stats) == 3, f"cli: {len(stats)} stats lines, expected 3")
    done = [x for x in lines if x.get("done")]
    check(len(done) == 1, "cli: no summary line")
    pngs = sorted(os.listdir(frames))
    check(len(pngs) == 3, f"cli: {len(pngs)} PNGs, expected 3")
    lit = [int((read_png(os.path.join(frames, p))[..., :3] > 0).sum())
           for p in pngs]
    check(min(lit) > 0, f"cli: black PNG (lit pixel counts {lit})")
    emit("cli", t0, particles=engine.particle_count,
         method=engine.method.name, paths=vars(engine.paths),
         particle_steps_per_sec=done[0]["particle_steps_per_sec"],
         lit_pixels=lit)


def _ws_connect(port: int):
    import base64

    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    key = base64.b64encode(os.urandom(16)).decode()
    s.sendall((f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(1)
    check(b" 101 " in resp.split(b"\r\n")[0], "server: no ws upgrade")
    return s


def _ws_send(s, obj) -> None:
    payload = json.dumps(obj).encode()
    mask = os.urandom(4)
    head = bytes([0x81])
    n = len(payload)
    head += (bytes([0x80 | n]) if n < 126
             else bytes([0x80 | 126]) + struct.pack(">H", n))
    s.sendall(head + mask + bytes(b ^ mask[i % 4]
                                  for i, b in enumerate(payload)))


def _ws_frames(s, mode: int, want: int, timeout: float) -> list:
    """The next ``want`` binary frames of wire mode ``mode``."""
    from particle_sim_tpu.app import server as srv

    out, end = [], time.time() + timeout
    while len(out) < want:
        check(time.time() < end, f"server: timed out waiting for mode "
              f"{mode} frames ({len(out)}/{want})")
        got = srv.ws_read_frame(s)
        check(got is not None, "server: connection closed")
        op, payload = got
        if op == 0x2 and struct.unpack("<I", payload[4:8])[0] == mode:
            out.append(payload)
    return out


def phase_server() -> None:
    from particle_sim_tpu.app import server as srv
    from particle_sim_tpu.engine import Engine
    from particle_sim_tpu.io import packer

    t0 = time.perf_counter()
    engine = Engine()
    check(engine.particle_count == 1_000_000,
          f"server: default count {engine.particle_count}, expected 1M")
    check_engine(engine, "server")
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    server = srv.StreamServer(engine, host="127.0.0.1", port=port,
                              target_fps=60)
    server.start()
    try:
        s = _ws_connect(port)
        _ws_send(s, {"type": "params", "gravity": 5.0, "color_mode": 1})
        _ws_send(s, {"type": "view", "mode": "raster", "width": 1280,
                     "height": 720})
        hdr = srv.HEADER_BYTES
        _ws_frames(s, 2, 2, timeout=300)        # compiles, warms
        raster = _ws_frames(s, 2, 5, timeout=300)
        w, h = struct.unpack("<II", raster[-1][hdr:hdr + 8])
        pix = np.frombuffer(raster[-1], np.uint8, offset=hdr + 8).reshape(
            h, w, 4)
        check((w, h) == (1280, 720), f"server: raster size {(w, h)}")
        check(int(pix[..., :3].max()) > 0, "server: black raster frame")
        _ws_send(s, {"type": "view", "mode": "compact",
                     "max_points": 250_000})
        _ws_frames(s, 1, 2, timeout=300)
        f16 = _ws_frames(s, 1, 5, timeout=300)
        pos, rgba = packer.unpack_f16(
            np.frombuffer(f16[-1], np.uint8, offset=hdr))
        check(pos.shape[0] > 0 and np.isfinite(pos).all(),
              "server: bad f16 payload")
        s.close()
    finally:
        server.stop()
    emit("server", t0, particles=engine.particle_count,
         raster_frames=len(raster), raster_lit=int(
             (pix[..., :3] > 0).any(axis=-1).sum()),
         f16_frames=len(f16), f16_points=int(pos.shape[0]))


def phase_gravity() -> None:
    runs = {
        "pm_1m": ["--pm", "--count", "1000000", "--pm-grid", "128",
                  "--steps", "5", "--stats-every", "5"],
        "pm_persist_4m": ["--pm-persist", "--count", "4000000",
                          "--steps", "5", "--stats-every", "5"],
        "pairwise_65k": ["--pairwise", "--count", "65536", "--steps", "3",
                         "--stats-every", "3"],
        "pmx_1m": ["--count", "1000000", "--generation", "filled",
                   "--pm2-size", "64", "--pm2-softening", "0.8",
                   "--pmx-size", "16", "--pmx-softening", "0.2",
                   "--steps", "5", "--stats-every", "5"],
    }
    for name, argv in runs.items():
        t0 = time.perf_counter()
        engine, lines = run_cli(argv)
        check_engine(engine, name)
        done = [x for x in lines if x.get("done")]
        check(len(done) == 1, f"{name}: no summary line")
        extra = {}
        if engine.pmx is not None:
            n_m, n_c = engine.pmx_member_count()
            check(n_m > 0, f"{name}: exact window has no members")
            extra = {"pmx_members": n_m, "pmx_corrected": n_c}
        emit(name, t0, particles=engine.particle_count,
             persistent=engine.persist_resolved(),
             update_ms=done[0].get("update_ms"), **extra)


def phase_parity() -> None:
    from particle_sim_tpu.utils import parity

    checks = [
        lambda: parity.attractor(1_000_000, 1),
        lambda: parity.attractor(1_000_000, 64),
        lambda: parity.pairwise(65_536),
        lambda: parity.persist_pm(4_000_000, 128),
        lambda: parity.raster(1_000_000),
    ]
    for c in checks:
        t0 = time.perf_counter()
        r = c()
        emit("parity", t0, **r)
        check(r["ok"], f"parity: {r['check']} err {r['err']} > {r['tol']}")


def phase_four_cards(devices) -> None:
    from particle_sim_tpu.parallel import mesh as mesh_lib
    from particle_sim_tpu.utils import parity

    check(len(devices) == 4, f"--four-cards needs 4 GPUs, JAX found "
          f"{len(devices)}")
    mesh = mesh_lib.make_mesh(devices)
    checks = [
        lambda: parity.mesh_attractor(mesh, 4_194_304, 1),
        lambda: parity.mesh_attractor(mesh, 4_194_304, 64, use_kernel=True),
        lambda: parity.mesh_ring(mesh, 65_536, use_kernel=True),
        lambda: parity.mesh_pm(mesh, 4_194_304),
        lambda: parity.mesh_persist_pm(mesh, 4_194_304),
        lambda: parity.mesh_render(mesh, 4_194_304),
    ]
    for c in checks:
        t0 = time.perf_counter()
        r = c()
        emit("four_cards", t0, **r)
        check(r["ok"], f"four_cards: {r['check']} err {r['err']} > "
              f"{r['tol']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device phase, on 4 GPUs")
    args = ap.parse_args(argv)
    try:
        import jax

        t0 = time.perf_counter()
        devices = jax.devices()
        require_gpu(devices)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        print(card, flush=True)

        from particle_sim_tpu.utils.cache import enable as enable_cache
        enable_cache()
        emit("device", t0, platform=devices[0].platform,
             kind=devices[0].device_kind, count=len(devices), card=card)
        if args.four_cards:
            phase_four_cards(devices)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                phase_cli(tmp)
            phase_server()
            phase_gravity()
            phase_parity()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — any crash is a failed phase
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
