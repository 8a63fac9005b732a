"""Streaming server: the device engine feeding a thin interactive client.

The reference couples simulation and presentation in one process
(egui/wgpu, ``app.rs:521-618``). Here the two split: the engine runs next
to the accelerator and streams packed position/color frames; the
interactive frontend survives as a thin client — here a browser
viewer (the reference itself ships a web build, ``index.html`` + trunk) —
sending input events back.

Stdlib only: a tiny HTTP server that serves the viewer page and upgrades
``/ws`` to a WebSocket (RFC 6455). One sim thread steps the engine and
re-packs the latest frame; per-client writer threads push the newest frame
(latest-wins, slow clients drop frames instead of stalling the sim — the
AutoVsync analog).

Wire protocol (binary server->client):
    u32 magic 'PSIM' | u32 mode (0 planar-f32, 1 compact-f16, 2 raster)
    | u32 count | u32 frame_id | u32 total_particles | f32 fps
    | f32 update_ms | u32 reflected_seq | f32 input_to_frame_ms
    | u32 flags (bit 0: paused — authoritative app state in the frame
                 header so EVERY client's pause button tracks a toggle
                 from any client, the app.rs:179,197-199 analog)
    | payload (mode 0: pos f32[3*count] then rgba u8[4*count];
               mode 1: 10-byte records — see io/packer.py;
               mode 2: u32 width | u32 height | rgba u8[4*width*height],
                       count = width*height — the frame is RENDERED ON
                       DEVICE (render/raster.py) so the wire cost
                       is resolution-bound, not N-bound: a 16M-particle
                       cloud streams as cheaply as a 10k one. The client
                       sends "camera" events instead of rendering.)
Client->server JSON events: params / mouse / pause / reset / resize /
method / generation / view / camera — mirroring the egui panel
(app.rs:320-518).
Events may carry a client ``seq``; ``reflected_seq`` is the newest event
sequence whose effect the frame's sim state includes, and
``input_to_frame_ms`` the server-side event-arrival -> frame-built time
for it. The client matches reflected_seq against its own send times for
the true input -> frame round trip — the split-architecture analog of
the reference's host-side update timer (app.rs:303-315), which a
one-process app gets for free.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

from ..core.params import (
    Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
)
from ..engine import Engine

logger = logging.getLogger("particle_sim_tpu.server")


def _pm2_list(pm2) -> tuple:
    """Engine.pm2 (None / single PM2Config / tuple) as a flat tuple."""
    if pm2 is None:
        return ()
    return pm2 if isinstance(pm2, tuple) else (pm2,)
from ..io import packer
from ..render.camera import Camera

MAGIC = 0x4D495350  # 'PSIM' little-endian
HEADER_FMT = "<IIIIIffIfI"   # see the wire-protocol docstring above
HEADER_BYTES = struct.calcsize(HEADER_FMT)  # 40
FLAG_PAUSED = 1 << 0
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_VIEWER_PATH = os.path.join(os.path.dirname(__file__), "viewer", "index.html")


# ---------------------------------------------------------------- WebSocket --
def _ws_accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def ws_encode(payload: bytes, opcode: int = 0x2) -> bytes:
    """Server frame (unmasked): binary by default."""
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def ws_read_frame(sock: socket.socket) -> Optional[tuple]:
    """-> (opcode, payload) or None on close/EOF."""
    def recv_exact(k: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < k:
            chunk = sock.recv(k - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    head = recv_exact(2)
    if head is None:
        return None
    opcode = head[0] & 0x0F
    masked = head[1] & 0x80
    n = head[1] & 0x7F
    if n == 126:
        ext = recv_exact(2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = recv_exact(8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    mask = recv_exact(4) if masked else b"\x00" * 4
    if mask is None:
        return None
    payload = recv_exact(n) if n else b""
    if payload is None:
        return None
    if masked:
        m = np.frombuffer((mask * ((n // 4) + 1))[:n], dtype=np.uint8)
        payload = (np.frombuffer(payload, dtype=np.uint8) ^ m).tobytes()
    if opcode == 0x8:  # close
        return None
    return opcode, payload


# ------------------------------------------------------------------- Server --
class StreamServer:
    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8787, target_fps: float = 60.0):
        self.engine = engine
        self.host, self.port = host, port
        self.target_dt = 1.0 / target_fps
        self.params = SimParams()
        self.frame_id = 0
        self.latest: Optional[bytes] = None
        self.cond = threading.Condition()
        self.lock = threading.Lock()       # guards engine + params mutations
        self.max_points = 250_000
        self.wire_mode = 0                 # 0 planar f32, 1 compact f16,
        #                                    2 server-side raster (RGBA8)
        self.raster_size = (1280, 720)     # mode-2 framebuffer (w, h)
        self.camera = Camera(aspect=1280.0 / 720.0)  # mode-2 viewpoint
        self.running = False
        self._state_version = 0
        # input->frame latency bookkeeping (all under self.lock):
        self._event_seq = 0        # newest client event seq + arrival time
        self._event_t = 0.0
        self._reflected_seq = 0    # newest seq the sim state includes
        self._reflected_t = 0.0
        self._latency_seq = 0      # last seq a latency was computed for
        self._latency_ms = 0.0
        self._threads: list = []
        self._sock: Optional[socket.socket] = None

    # -- input events (client JSON -> engine mutations) ----------------------
    @staticmethod
    def _coerce_params(fields: dict) -> dict:
        """Validate client-supplied SimParams fields NOW: a bad value
        stored here would otherwise crash the sim/pack threads later (in
        SimParams.pack), silently freezing the stream for every client."""
        out = {}
        for k, v in fields.items():
            if k not in SimParams.__dataclass_fields__:
                continue
            if k == "mouse_position":
                x, y, z = v  # raises for wrong arity/non-iterables
                out[k] = (float(x), float(y), float(z))
            elif k == "is_mouse_dragging":
                out[k] = bool(v)
            elif k == "color_mode":
                out[k] = int(v)
            else:
                out[k] = float(v)
        return out

    def handle_event(self, ev: dict) -> None:
        t = ev.get("type")
        with self.lock:
            if "seq" in ev:
                try:
                    self._event_seq = int(ev["seq"])
                    self._event_t = time.perf_counter()
                except (TypeError, ValueError):
                    pass
            p = self.params
            if t == "params":
                self.params = p.replace(**self._coerce_params(ev))
            elif t == "mouse":
                x, y, z = ev["pos"]
                self.params = p.replace(
                    mouse_position=(float(x), float(y), float(z)),
                    is_mouse_dragging=bool(ev.get("dragging", False)))
            elif t == "pause":
                self.engine.set_paused(not self.engine.is_paused())
            elif t == "reset":
                self.engine.reset()
            elif t == "resize":
                self.engine.resize(int(ev["count"]))
            elif t == "generation":
                mode = (SphereGeneration.HOLLOW if ev["mode"] == "hollow"
                        else SphereGeneration.FILLED)
                self.engine.resize(self.engine.particle_count, mode)
            elif t == "method":
                try:
                    self.engine.set_method(Method[ev["name"].upper()])
                except (KeyError, ValueError):
                    pass
            elif t == "view":
                self.max_points = int(ev.get("max_points", self.max_points))
                self.wire_mode = {"planar": 0, "compact": 1,
                                  "raster": 2}.get(
                    ev.get("mode", ""), self.wire_mode)
                if "width" in ev or "height" in ev:
                    w, h = self.raster_size
                    w = int(ev.get("width", w))
                    h = int(ev.get("height", h))
                    w = max(64, min(3840, w))
                    h = max(64, min(2160, h))
                    self.raster_size = (w, h)
                    self.camera.aspect = w / h
            elif t == "camera":
                # mode-2 viewpoint: the thin client owns the free-fly
                # camera math (its JS port of render/camera.py) and ships
                # the resulting pose; the server only validates it
                def _f(v):
                    v = float(v)
                    if not np.isfinite(v):   # fail fast: a NaN pose would
                        raise ValueError(v)  # silently render black frames
                    return v

                # validate EVERY field before assigning ANY: an event
                # with a valid pos but NaN yaw must not leave the pose
                # half-applied for subsequent frames
                upd = {}
                if "pos" in ev:
                    x, y, z = ev["pos"]
                    upd["position"] = np.array([_f(x), _f(y), _f(z)])
                if "yaw" in ev:
                    upd["yaw"] = _f(ev["yaw"])
                if "pitch" in ev:
                    lim = np.pi / 2.0 - 0.01   # camera.rs:168-174 clamp
                    upd["pitch"] = min(lim, max(-lim, _f(ev["pitch"])))
                if "fov" in ev:
                    upd["fov"] = min(np.pi * 2 / 3,
                                     max(np.pi / 18, _f(ev["fov"])))
                for k, v in upd.items():
                    setattr(self.camera, k, v)
            elif t == "solver":
                # runtime self-gravity switch: off / particle-mesh / direct.
                # Solver name and G changes reuse compiled steps (G is
                # traced); a NEW softening value is a new static PMConfig
                # and compiles a fresh PM step on first use — the viewer
                # therefore only sends solver events on slider release.
                name = ev.get("name", "off")
                g = float(ev.get("g", 1.0))
                eps = float(ev.get("softening", 2.0))
                if name in ("pm", "pm_persist"):
                    self._apply_pm_solver_event(ev, name, g, eps)
                elif name == "direct":
                    self.engine.pm = None
                    self.engine.set_pmx(None)   # window first: set_pm2
                    self.engine.set_pm2(None)   # cross-checks self.pmx
                    self.engine.pairwise = PairwiseParams(g, eps)
                else:
                    self.engine.pm = None
                    self.engine.set_pmx(None)
                    self.engine.set_pm2(None)
                    self.engine.pairwise = None
            # every event can change what the next frame shows (pause flag,
            # reset state, camera pose in raster mode, color mode, ...) —
            # bump the version so the pack loop re-streams even while the
            # sim is paused (a paused engine stops bumping it in _sim_loop)
            self._state_version += 1

    def _apply_pm_solver_event(self, ev: dict, name: str, g: float,
                               eps: float) -> None:
        """Validate the ENTIRE candidate solver configuration — coarse
        PM + refinement stack + exact window — before committing ANY of
        it (committing engine.pm first let a retained stack that is
        invalid under the new softening crash the sim thread at trace
        time inside engine.step; now the event is rejected loudly and the
        running configuration is untouched)."""
        from ..ops.pm2 import PM2Config, _validate_levels

        eng = self.engine
        new_pm = PMConfig(softening=eps,
                          auto_box=bool(ev.get("auto_box", False)))
        want_persist = name == "pm_persist"
        # candidate refinement stack: from the event when present
        # (parallel size/softening lists, outermost first; [] clears),
        # else the retained one
        stack = eng.pm2
        if "pm2_sizes" in ev:
            try:
                sizes = [float(s) for s in ev["pm2_sizes"]]
                softs = [float(s) for s in ev.get("pm2_softenings", [])]
                if len(softs) != len(sizes):
                    raise ValueError(
                        "pm2 size/softening lists differ in length")
                cand = tuple(PM2Config(window_min=None, window_size=s,
                                       softening=e)
                             for s, e in zip(sizes, softs))
                stack = (None if not cand
                         else cand[0] if len(cand) == 1 else cand)
            except (TypeError, ValueError) as e:
                logger.warning("pm2 event rejected: %s (keeping the "
                               "old stack)", e)
        # candidate exact window: pmx_size <= 0 clears it; absent fields
        # keep the installed window
        pmx_cfg = getattr(eng, "pmx", None)
        if "pmx_size" in ev:
            from ..ops.pmx import PMXConfig
            try:
                size = float(ev["pmx_size"])
                pmx_cfg = None if size <= 0.0 else PMXConfig(
                    window_size=size,
                    softening=float(ev.get("pmx_softening", 0.1)),
                    capacity=int(ev.get("pmx_capacity", 65536)))
            except (TypeError, ValueError) as e:
                logger.warning("pmx event rejected: %s (keeping the "
                               "old window)", e)
        levels = (stack if isinstance(stack, tuple)
                  else (stack,) if stack is not None else ())
        try:
            if levels:
                _validate_levels(new_pm, levels)
            if eng.mesh is not None and stack is not None \
                    and not want_persist:
                raise ValueError("multi-device pm2 requires pm_persist")
            if pmx_cfg is not None:
                from ..ops import pmx as pmx_mod
                if want_persist and not (isinstance(stack, tuple)
                                         and len(stack) > 1):
                    raise ValueError(
                        "pmx + pm_persist needs a MULTI-level pm2 "
                        "stack (tuple)")
                if eng.mesh is not None and not isinstance(stack, tuple):
                    raise ValueError("multi-device pmx needs a "
                                     "MULTI-level pm2 stack")
                pmx_mod._validate(new_pm, levels, pmx_cfg)
        except ValueError as e:
            logger.warning("solver event rejected: %s (keeping the "
                           "current solver stack)", e)
            return
        # commit — pm first so set_pm2/set_pmx re-validate against the
        # new coarse config; window cleared around the stack swap so the
        # engine-side cross-checks never see a mixed old/new state
        eng.pm = new_pm
        eng.pairwise = PairwiseParams(g, eps)
        eng.pm_persist = want_persist
        eng.set_pmx(None)
        eng.set_pm2(stack)
        if pmx_cfg is not None:
            eng.set_pmx(pmx_cfg)
        if "two_tier" in ev:
            # repair strategy (full-sort-only for violent scenes) — a
            # static jit arg, so flipping it just compiles
            # the other step variant; the persistent state stays valid
            eng.two_tier = bool(ev["two_tier"])

    # -- frame production -----------------------------------------------------
    def _build_frame(self) -> bytes:
        # dispatch the device-side pack under the lock (orders it against
        # concurrent donating steps), fetch to host outside it so the sim
        # thread never waits on the transfer
        with self.lock:
            mode = self.wire_mode  # read once: header must match payload
            if mode == 2:
                w, h = self.raster_size
                fb_dev = self.engine.render_frame_device(
                    self.camera, self.params, width=w, height=h)
            else:
                pos_dev, rgba_dev = self.engine.frame_arrays_device(
                    self.params, self.max_points)
            total = self.engine.particle_count
            stats = self.engine.stats
            paused = self.engine.is_paused()
            rseq, rt = self._reflected_seq, self._reflected_t
        if mode == 2:
            fb = np.asarray(fb_dev)          # fetch outside the lock
        else:
            pos = np.asarray(pos_dev)
            rgba = np.asarray(rgba_dev)
        if rseq > self._latency_seq:
            # first frame reflecting event rseq: freeze its end-to-end
            # server latency (arrival -> payload fetched); later frames
            # re-report the same number instead of a growing stale one
            self._latency_seq = rseq
            self._latency_ms = (time.perf_counter() - rt) * 1e3
        if mode == 2:
            h, w = fb.shape[0], fb.shape[1]
            count = w * h
            payload = struct.pack("<II", w, h) + fb.tobytes()
        elif mode == 1:
            payload = packer.pack_f16(pos, rgba).tobytes()
            count = len(payload) // packer.RECORD_BYTES
        else:
            count = pos.shape[1]
            payload = pos.tobytes() + rgba.tobytes()
        head = struct.pack(
            HEADER_FMT, MAGIC, mode, count, self.frame_id,
            total, float(stats.fps), float(stats.update_ms),
            rseq, float(self._latency_ms),
            FLAG_PAUSED if paused else 0)
        return head + payload

    def _sim_loop(self) -> None:
        while self.running:
            t0 = time.perf_counter()
            with self.lock:
                stepped = not self.engine.is_paused()
                seq, seq_t = self._event_seq, self._event_t
                self.engine.step(self.params)
                if stepped:
                    # this step consumed every event up to seq: frames
                    # packed from it reflect that input
                    self._reflected_seq, self._reflected_t = seq, seq_t
            if stepped:
                # paused frames are identical: don't re-pack/re-stream them
                self._state_version += 1
            elapsed = time.perf_counter() - t0
            if elapsed < self.target_dt:
                time.sleep(self.target_dt - elapsed)

    def _pack_loop(self) -> None:
        """Builds outgoing frames from the newest state, decoupled from the
        sim cadence (frame fetch/pack never stalls stepping)."""
        packed_version = -1
        while self.running:
            if self._state_version == packed_version:
                time.sleep(0.002)
                continue
            packed_version = self._state_version
            frame = self._build_frame()
            with self.cond:
                self.latest = frame
                self.frame_id += 1
                self.cond.notify_all()

    # -- client handling ------------------------------------------------------
    def _client_writer(self, sock: socket.socket) -> None:
        last_sent = -1
        try:
            while self.running:
                with self.cond:
                    self.cond.wait_for(
                        lambda: self.frame_id != last_sent or not self.running,
                        timeout=1.0)
                    frame, last_sent = self.latest, self.frame_id
                if frame is not None:
                    sock.sendall(ws_encode(frame))
        except OSError:
            pass

    def _client_reader(self, sock: socket.socket) -> None:
        try:
            while self.running:
                got = ws_read_frame(sock)
                if got is None:
                    break
                opcode, payload = got
                if opcode == 0x9:  # ping -> pong
                    sock.sendall(ws_encode(payload, opcode=0xA))
                elif opcode == 0x1:
                    try:
                        ev = json.loads(payload.decode())
                        if isinstance(ev, dict):
                            self.handle_event(ev)
                    except Exception:
                        # a malformed client event must never kill the
                        # reader thread (or worse, a shared loop)
                        pass
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _handle_conn(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(5.0)
            req = b""
            while b"\r\n\r\n" not in req:
                chunk = sock.recv(4096)
                if not chunk:
                    return
                req += chunk
            head = req.decode("latin-1")
            lines = head.split("\r\n")
            path = lines[0].split(" ")[1] if " " in lines[0] else "/"
            headers = {}
            for line in lines[1:]:
                if ": " in line:
                    k, v = line.split(": ", 1)
                    headers[k.lower()] = v

            if "sec-websocket-key" in headers and path.startswith("/ws"):
                accept = _ws_accept_key(headers["sec-websocket-key"])
                sock.sendall((
                    "HTTP/1.1 101 Switching Protocols\r\n"
                    "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
                ).encode())
                sock.settimeout(None)
                # hello: capability probe for the client (app.rs:86-100
                # analog — lets the UI grey out unavailable backends)
                from ..engine import available_methods
                hello = json.dumps({
                    "type": "hello",
                    "methods": [m.name.lower() for m in available_methods()],
                    "method": self.engine.method.name.lower(),
                    "count": self.engine.particle_count,
                    "paused": self.engine.is_paused(),
                    "solver": (("pm_persist" if self.engine.persist_resolved()
                                else "pm") if self.engine.pm is not None
                               else "direct" if self.engine.pairwise
                               else "off"),
                    "solver_g": (self.engine.pairwise.gravitational_constant
                                 if self.engine.pairwise else 1.0),
                    "solver_softening": (
                        self.engine.pm.softening if self.engine.pm
                        else self.engine.pairwise.softening
                        if self.engine.pairwise else 2.0),
                    # refinement stack (outermost first; [] = none) so
                    # the panel's pm2 inputs reflect server state
                    "pm2_sizes": [c.window_size for c in _pm2_list(
                        self.engine.pm2)],
                    "pm2_softenings": [c.softening for c in _pm2_list(
                        self.engine.pm2)],
                    # exact window (0 = none) so the panel's pmx inputs
                    # reflect server state too
                    "pmx_size": (self.engine.pmx.window_size
                                 if getattr(self.engine, "pmx", None)
                                 else 0),
                    "pmx_softening": (self.engine.pmx.softening
                                      if getattr(self.engine, "pmx", None)
                                      else 0),
                    # persistent-repair strategy so the panel's checkbox
                    # reflects --no-two-tier / a prior solver event
                    "two_tier": bool(getattr(self.engine, "two_tier",
                                             True)),
                    # current wire mode + raster size so the viewer's
                    # Wire-format select reflects a --view-mode raster
                    # server instead of defaulting to planar
                    "wire_mode": {0: "planar", 1: "compact",
                                  2: "raster"}[self.wire_mode],
                    "raster_size": list(self.raster_size),
                })
                sock.sendall(ws_encode(hello.encode(), opcode=0x1))
                w = threading.Thread(target=self._client_writer, args=(sock,),
                                     daemon=True)
                w.start()
                self._client_reader(sock)
            else:
                # serve the viewer shell (whitelisted static files)
                static = {
                    "/": ("index.html", "text/html"),
                    "/index.html": ("index.html", "text/html"),
                    "/manifest.json": ("manifest.json", "application/json"),
                    "/sw.js": ("sw.js", "application/javascript"),
                }
                for icon in ("icon-1024.png", "icon-256.png",
                             "icon_ios_touch_192.png",
                             "maskable_icon_x512.png", "favicon.png"):
                    static[f"/assets/{icon}"] = (
                        os.path.join("assets", icon), "image/png")
                entry = static.get(path.split("?")[0])
                try:
                    if entry is None:
                        raise FileNotFoundError(path)
                    fname, ctype = entry
                    fpath = os.path.join(os.path.dirname(_VIEWER_PATH), fname)
                    with open(fpath, "rb") as f:
                        body = f.read()
                    cache = ("max-age=86400" if ctype == "image/png"
                             else "no-cache")
                    sock.sendall(
                        f"HTTP/1.1 200 OK\r\nContent-Type: {ctype}\r\n"
                        f"Cache-Control: {cache}\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n".encode()
                        + body)
                except (OSError, FileNotFoundError):
                    sock.sendall(b"HTTP/1.1 404 Not Found\r\n\r\n")
                sock.close()
        except OSError:
            pass

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        self.running = True
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(8)
        for target in (self._sim_loop, self._pack_loop, self._accept_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def _accept_loop(self) -> None:
        while self.running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def stop(self) -> None:
        self.running = False
        with self.cond:
            self.cond.notify_all()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # bounded join: an in-flight step (seconds on a CPU backend)
        # must not straggle into whatever runs next — observed starving
        # the next test's frame deadline on the 1-core CI box
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(10.0)

    def serve_forever(self) -> None:
        self.start()
        print(f"viewer: http://{self.host}:{self.port}/  "
              f"(ws on /ws, {self.engine.particle_count} particles, "
              f"method {self.engine.method.name})")
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            self.stop()


def main(argv=None) -> int:
    import argparse
    import re

    from ..utils.cache import enable as enable_compile_cache
    enable_compile_cache()

    ap = argparse.ArgumentParser(description="particle_sim_tpu stream server")
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--method", choices=["auto", "jnp", "pallas"],
                    default="auto")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--max-points", type=int, default=250_000)
    ap.add_argument("--view-mode", choices=["planar", "compact", "raster"],
                    default="planar",
                    help="wire mode: stream points (planar/compact) or "
                    "render on device and stream the framebuffer (raster "
                    "— resolution-bound wire cost, use for huge N)")
    ap.add_argument("--raster-size", default="1280x720",
                    help="raster-mode framebuffer, WxH")
    ap.add_argument("--pm", action="store_true",
                    help="start with particle-mesh self-gravity on")
    ap.add_argument("--pm-persist", action="store_true",
                    help="persistent cell-ordered PM state (implies --pm)")
    ap.add_argument("--no-two-tier", action="store_true",
                    help="full-sort-only persistent repairs (skip the "
                    "segment-local tier-1 pass; for violent collapse "
                    "scenes)")
    ap.add_argument("--pm-g", type=float, default=1.0)
    ap.add_argument("--pm-softening", type=float, default=2.0)
    ap.add_argument("--pm2-size", type=float, nargs="+", default=[0.0],
                    help="refinement-window extent(s), outermost first "
                    "(two-level PM; several values nest multi-level) — "
                    "implies --pm; composes with --pm-persist")
    ap.add_argument("--pm2-softening", type=float, nargs="+",
                    default=[0.5], help="fine softening, one per "
                    "--pm2-size value")
    args = ap.parse_args(argv)

    method = {"auto": None, "jnp": Method.JNP,
              "pallas": Method.PALLAS}[args.method]
    want_pm = args.pm or args.pm_persist or args.pm2_size[0] > 0.0
    pm2_cfg = None
    if args.pm2_size[0] > 0.0:
        from ..ops.pm2 import PM2Config
        sizes, softs = args.pm2_size, args.pm2_softening
        if len(softs) != len(sizes):
            ap.error("--pm2-softening needs one value per --pm2-size")
        levels = tuple(PM2Config(window_min=None, window_size=s,
                                 softening=e)
                       for s, e in zip(sizes, softs))
        pm2_cfg = levels if len(levels) > 1 else levels[0]
    engine = Engine(
        particle_count=args.count, method=method,
        pm=PMConfig(softening=args.pm_softening) if want_pm else None,
        pairwise=(PairwiseParams(args.pm_g, args.pm_softening)
                  if want_pm else None),
        pm2=pm2_cfg,
        pm_persist=True if args.pm_persist else None,
        two_tier=not args.no_two_tier)
    server = StreamServer(engine, host=args.host, port=args.port,
                          target_fps=args.fps)
    server.max_points = args.max_points
    m = re.fullmatch(r"(\d+)x(\d+)", args.raster_size.strip().lower())
    if m is None:
        ap.error(f"--raster-size must be WxH (got {args.raster_size!r})")
    server.handle_event({"type": "view", "mode": args.view_mode,
                         "width": int(m.group(1)), "height": int(m.group(2))})
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
