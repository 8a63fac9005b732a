"""Packer parity and stream-server protocol tests (loopback, no browser)."""

import base64
import hashlib
import json
import socket
import struct
import time

import numpy as np
import pytest

from particle_sim_tpu.core.params import Method, SimParams
from particle_sim_tpu.engine import Engine
from particle_sim_tpu.app import server as server_mod
from particle_sim_tpu.io import packer

HDR = server_mod.HEADER_BYTES


class TestPacker:
    def setup_method(self):
        rng = np.random.default_rng(3)
        self.pos = (rng.normal(size=(3, 5000)) * 50).astype(np.float32)
        self.rgba = rng.integers(0, 256, (5000, 4), dtype=np.uint8)

    def test_f16_native_matches_numpy(self):
        if not packer.have_native():
            pytest.skip("native packer unavailable")
        a = packer.pack_f16(self.pos, self.rgba, stride=2)
        lib = packer._lib
        packer._lib = None
        try:
            b = packer.pack_f16(self.pos, self.rgba, stride=2)
        finally:
            packer._lib = lib
        np.testing.assert_array_equal(a, b)

    def test_f16_roundtrip_precision(self):
        buf = packer.pack_f16(self.pos, self.rgba)
        p, c = packer.unpack_f16(buf)
        np.testing.assert_array_equal(c, self.rgba)
        # f16 relative precision is 2^-11
        rel = np.abs(p - self.pos.T) / (1.0 + np.abs(self.pos.T))
        assert rel.max() < 6e-4

    def test_planar_gather_exact(self):
        p, c = packer.pack_planar_f32(self.pos, self.rgba, stride=7)
        np.testing.assert_array_equal(p, self.pos[:, ::7])
        np.testing.assert_array_equal(c, self.rgba[::7])


# ---------------------------------------------------------------- ws client --
class _WsSock:
    """Socket wrapper that replays handshake-read overshoot bytes first."""

    def __init__(self, sock: socket.socket, leftover: bytes):
        self._s = sock
        self._buf = leftover

    def recv(self, n: int) -> bytes:
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        return self._s.recv(n)

    def sendall(self, data: bytes) -> None:
        self._s.sendall(data)

    def close(self) -> None:
        self._s.close()


def ws_connect(host, port, timeout=10.0):
    s = socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(b"0123456789abcdef").decode()
    s.sendall((f"GET /ws HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    head, _, leftover = resp.partition(b"\r\n\r\n")
    assert b"101" in head.split(b"\r\n")[0]
    expect = base64.b64encode(hashlib.sha1(
        (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
    ).digest())
    assert expect in head
    return _WsSock(s, leftover)


def ws_send_text(s, obj):
    payload = json.dumps(obj).encode()
    mask = b"\x11\x22\x33\x44"
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    assert len(payload) < 126
    s.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + masked)


def ws_recv_frame(s):
    def rexact(k):
        buf = b""
        while len(buf) < k:
            c = s.recv(k - len(buf))
            if not c:
                raise ConnectionError("eof")
            buf += c
        return buf
    head = rexact(2)
    n = head[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", rexact(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", rexact(8))[0]
    return head[0] & 0x0F, rexact(n)


def ws_recv_binary(s):
    """Next binary frame, skipping text frames (e.g. the hello message)."""
    while True:
        op, payload = ws_recv_frame(s)
        if op == 0x2:
            return op, payload


def ws_recv_text(s):
    while True:
        op, payload = ws_recv_frame(s)
        if op == 0x1:
            return json.loads(payload.decode())


@pytest.fixture
def server():
    from particle_sim_tpu.app.server import StreamServer

    engine = Engine(particle_count=2000, method=Method.JNP)
    srv = StreamServer(engine, host="127.0.0.1", port=0, target_fps=30)
    # port 0: rebind to an ephemeral port
    srv._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv._sock.bind(("127.0.0.1", 0))
    srv.port = srv._sock.getsockname()[1]
    srv._sock.listen(8)
    srv.running = True
    import threading
    for target in (srv._sim_loop, srv._pack_loop, srv._accept_loop):
        t = threading.Thread(target=target, daemon=True)
        t.start()
        srv._threads.append(t)   # stop() joins them (no stragglers
    yield srv                    # leaking CPU into the next test)
    srv.stop()


class TestStreamServer:
    def test_http_serves_viewer(self, server):
        s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        resp = b""
        s.settimeout(5)
        try:
            while True:
                c = s.recv(65536)
                if not c:
                    break
                resp += c
                if b"</html>" in resp:
                    break
        except socket.timeout:
            pass
        assert b"200 OK" in resp and b"particle-sim-tpu" in resp

    def test_hello_capabilities(self, server):
        s = ws_connect("127.0.0.1", server.port)
        hello = ws_recv_text(s)
        assert hello["type"] == "hello"
        assert "jnp" in hello["methods"]
        assert hello["count"] == 2000
        # panel-reflection fields ride the hello (two_tier joins the
        # pm2/pmx solver-state block)
        assert hello["two_tier"] is True
        s.close()

    def test_frame_stream_and_events(self, server):
        s = ws_connect("127.0.0.1", server.port)
        op, frame = ws_recv_binary(s)
        assert op == 0x2
        (magic, mode, count, fid, total, fps, upd, rseq,
         input_ms, flags) = struct.unpack(server_mod.HEADER_FMT,
                                          frame[:HDR])
        assert magic == 0x4D495350
        assert mode == 0
        assert total == 2000
        assert count >= total  # capacity slots; padding carries alpha 0
        pos = np.frombuffer(frame, dtype=np.float32,
                            count=3 * count, offset=HDR).reshape(3, -1)
        rgba = np.frombuffer(frame, dtype=np.uint8, count=4 * count,
                             offset=HDR + 12 * count).reshape(-1, 4)
        assert np.isfinite(pos).all()
        # hollow sphere: radius ~50 for every active particle
        radii = np.sqrt((pos[:, :total] ** 2).sum(0))
        assert abs(np.median(radii) - 50.0) < 2.0
        assert (rgba[:total, 3] == 255).all()
        assert (rgba[total:, 3] == 0).all()  # padding discarded client-side

        # resize event -> total shrinks in a later frame
        ws_send_text(s, {"type": "resize", "count": 500})
        deadline = time.time() + 10
        while time.time() < deadline:
            _, frame = ws_recv_binary(s)
            total = struct.unpack("<I", frame[16:20])[0]
            if total == 500:
                break
        assert total == 500

        # pause toggles engine state
        ws_send_text(s, {"type": "pause"})
        deadline = time.time() + 5
        while time.time() < deadline and not server.engine.is_paused():
            time.sleep(0.05)
        assert server.engine.is_paused()
        s.close()

    def test_input_to_frame_latency(self, server):
        """Events carry a seq; frames report the newest reflected seq and
        the server-side input->frame time (the measured interactivity of
        the split architecture — app.rs:303-315 analog)."""
        s = ws_connect("127.0.0.1", server.port)
        ws_recv_binary(s)
        ws_send_text(s, {"type": "mouse", "pos": [1.0, 2.0, 3.0],
                         "dragging": True, "seq": 41})
        t_sent = time.time()
        deadline = time.time() + 10
        rseq = 0
        while time.time() < deadline:
            _, frame = ws_recv_binary(s)
            rseq, input_ms = struct.unpack("<If", frame[28:36])
            if rseq >= 41:
                break
        rtt_ms = (time.time() - t_sent) * 1e3
        assert rseq == 41
        # the reflecting frame's server latency must be a plausible
        # positive number bounded by the measured client round trip
        assert 0.0 < input_ms < rtt_ms + 1e3
        s.close()

    def test_compact_f16_mode(self, server):
        s = ws_connect("127.0.0.1", server.port)
        ws_recv_binary(s)
        ws_send_text(s, {"type": "view", "mode": "compact"})
        deadline = time.time() + 10
        mode = 0
        while time.time() < deadline:
            _, frame = ws_recv_binary(s)
            mode, count = struct.unpack("<II", frame[8:16])[0], struct.unpack(
                "<I", frame[8:12])[0]
            mode = struct.unpack("<I", frame[4:8])[0]
            if mode == 1:
                break
        assert mode == 1
        count = struct.unpack("<I", frame[8:12])[0]
        assert len(frame) == HDR + count * packer.RECORD_BYTES
        pos, rgba = packer.unpack_f16(
            np.frombuffer(frame, np.uint8, offset=HDR))
        active = rgba[:, 3] > 0
        radii = np.linalg.norm(pos[active], axis=1)
        assert abs(np.median(radii) - 50.0) < 2.0  # hollow sphere survives f16
        s.close()

    def test_static_files(self, server):
        for path, marker in [("/manifest.json", b"psim-tpu"),
                             ("/manifest.json", b"maskable"),
                             ("/sw.js", b"psim-tpu-v1"),
                             ("/assets/favicon.png", b"\x89PNG"),
                             ("/assets/icon-256.png", b"\x89PNG"),
                             ("/assets/icon_ios_touch_192.png", b"\x89PNG"),
                             ("/assets/maskable_icon_x512.png", b"\x89PNG"),
                             ("/nope", b"404")]:
            s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
            s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
            resp = b""
            s.settimeout(3)
            try:
                while len(resp) < 65536:
                    c = s.recv(65536)
                    if not c:
                        break
                    resp += c
            except socket.timeout:
                pass
            assert marker in resp, path
            s.close()

    def test_param_and_mouse_events(self, server):
        s = ws_connect("127.0.0.1", server.port)
        ws_recv_binary(s)
        ws_send_text(s, {"type": "params", "gravity": 3.5, "color_mode": 2})
        ws_send_text(s, {"type": "mouse", "pos": [1, 2, 3], "dragging": True})
        deadline = time.time() + 5
        while time.time() < deadline:
            if (server.params.gravity == 3.5
                    and server.params.is_mouse_dragging):
                break
            time.sleep(0.05)
        assert server.params.gravity == 3.5
        assert server.params.color_mode == 2
        assert server.params.mouse_position == (1, 2, 3)
        assert server.params.is_mouse_dragging
        s.close()


class TestSolverEvents:
    def test_solver_event_switches_engine(self):
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=1500, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        assert engine.pm is None and engine.pairwise is None
        srv.handle_event({"type": "solver", "name": "pm",
                          "g": 0.5, "softening": 3.0})
        assert engine.pm is not None
        assert engine.pm.softening == 3.0
        assert engine.pairwise.gravitational_constant == 0.5
        engine.step(SimParams(delta_time=0.016))  # PM step compiles + runs
        import numpy as np
        assert np.isfinite(engine.state.positions()).all()

        srv.handle_event({"type": "solver", "name": "direct",
                          "g": 1.0, "softening": 0.5})
        assert engine.pm is None and engine.pairwise is not None
        engine.step(SimParams(delta_time=0.016))

        srv.handle_event({"type": "solver", "name": "off"})
        assert engine.pm is None and engine.pairwise is None
        engine.step(SimParams(delta_time=0.016))

    def test_solver_event_auto_box(self):
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=1200, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.3,
                          "softening": 5.0, "auto_box": True})
        assert engine.pm is not None and engine.pm.auto_box
        engine.step(SimParams(delta_time=0.01))
        import numpy as np
        assert np.isfinite(engine.state.positions()).all()

    @pytest.mark.slow
    def test_solver_event_pm2_stack(self):
        """pm2_sizes/pm2_softenings on a solver event install / swap /
        clear the refinement stack at runtime (live multi-level
        switching); invalid stacks are rejected keeping the old one."""
        import numpy as np
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method
        from particle_sim_tpu.ops.pm2 import PM2Config

        engine = Engine(particle_count=1500, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0,
                          "pm2_sizes": [32.0, 8.0],
                          "pm2_softenings": [0.6, 0.2]})
        assert isinstance(engine.pm2, tuple) and len(engine.pm2) == 2
        assert engine.pm2[1].window_size == 8.0
        engine.step(SimParams(delta_time=0.016))   # pmn step runs
        assert np.isfinite(engine.state.positions()).all()
        # single level normalizes to the plain two-level mode
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0, "pm2_sizes": [24.0],
                          "pm2_softenings": [0.6]})
        assert isinstance(engine.pm2, PM2Config)
        # a bad nesting is rejected, keeping the previous stack
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0, "pm2_sizes": [8.0, 32.0],
                          "pm2_softenings": [0.6, 0.2]})
        assert isinstance(engine.pm2, PM2Config)
        assert engine.pm2.window_size == 24.0
        # empty lists clear the stack
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0, "pm2_sizes": [],
                          "pm2_softenings": []})
        assert engine.pm2 is None
        engine.step(SimParams(delta_time=0.016))
        assert np.isfinite(engine.state.positions()).all()

    def test_solver_event_validates_whole_config(self):
        """A solver event whose NEW coarse softening
        is incompatible with the RETAINED refinement stack must be
        rejected as a whole at event time — the old handler committed
        engine.pm first, then engine.step() raised inside the sim
        thread, killing the stream."""
        import numpy as np
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=1500, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0, "pm2_sizes": [24.0],
                          "pm2_softenings": [0.6]})
        assert engine.pm.softening == 3.0
        assert engine.pm2 is not None and engine.pm2.softening == 0.6
        # new coarse softening below the retained stack's: whole event
        # rejected, nothing committed
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.9,
                          "softening": 0.5})
        assert engine.pm.softening == 3.0
        assert engine.pairwise.gravitational_constant == 0.5
        engine.step(SimParams(delta_time=0.016))   # still healthy
        assert np.isfinite(engine.state.positions()).all()

    def test_solver_event_pmx_live(self):
        """The window-exact correction is runtime-
        switchable through the same validate-then-apply event path as
        the pm2 stack; invalid windows are rejected loudly keeping the
        old one; pmx_size <= 0 clears it."""
        import numpy as np
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=1500, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0, "pmx_size": 8.0,
                          "pmx_softening": 0.15, "pmx_capacity": 512})
        assert engine.pmx is not None
        assert engine.pmx.window_size == 8.0
        assert engine.pmx.capacity == 512
        engine.step(SimParams(delta_time=0.008, gravity=0.0))
        assert np.isfinite(engine.state.positions()).all()
        # invalid: exact softening above the mesh's — rejected, window
        # kept
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0, "pmx_size": 8.0,
                          "pmx_softening": 5.0})
        assert engine.pmx.softening == 0.15
        # absent pmx fields: the installed window is retained and
        # re-validated against the new coarse config
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 2.0})
        assert engine.pmx is not None and engine.pm.softening == 2.0
        # pmx_size 0 clears it
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 2.0, "pmx_size": 0})
        assert engine.pmx is None
        engine.step(SimParams(delta_time=0.008, gravity=0.0))
        assert np.isfinite(engine.state.positions()).all()

    def test_solver_event_two_tier(self):
        """The persistent-repair strategy flips live through the solver
        event (full-sort-only repairs for violent scenes) and is
        reported back in the state message so the panel checkbox
        reflects server state."""
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=1500, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        assert engine.two_tier is True
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 3.0, "two_tier": False})
        assert engine.two_tier is False
        # absent field keeps the current strategy
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 2.0})
        assert engine.two_tier is False
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 2.0, "two_tier": True})
        assert engine.two_tier is True
        # a REJECTED event must not commit its two_tier either (the
        # validate-then-commit contract covers every field)
        srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                          "softening": 2.0, "two_tier": False,
                          "pmx_size": 8.0, "pmx_softening": 5.0})
        assert engine.two_tier is True

    def test_solver_event_pmx_reflected_in_header(self, server):
        """The live-panel round trip: a pmx solver event carries a seq;
        the first frame stepped after it reflects that seq in the wire
        header, and the engine is running the exact window by then."""
        s = ws_connect("127.0.0.1", server.port)
        ws_recv_binary(s)
        # ws_send_text only does short frames (<126 B): keep it terse
        ws_send_text(s, {"type": "solver", "name": "pm", "pmx_size": 8,
                         "pmx_softening": 0.15, "seq": 91})
        # generous deadline: each pm+pmx step is a full-grid FFT on the
        # 1-core CI box, and only a STEPPED frame reflects the seq
        deadline = time.time() + 60
        rseq = 0
        while time.time() < deadline:
            _, frame = ws_recv_binary(s)
            rseq = struct.unpack("<I", frame[28:32])[0]
            if rseq >= 91:
                break
        assert rseq >= 91
        assert server.engine.pmx is not None
        assert server.engine.pmx.window_size == 8.0
        s.close()

    def test_bad_params_event_fails_fast_not_later(self):
        """Malformed client params must raise AT EVENT TIME (where the
        reader thread catches it), never poison stored params and crash
        the sim/pack threads later in SimParams.pack()."""
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=1000, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        before = srv.params
        for ev in ({"type": "params", "delta_time": "fast"},
                   {"type": "params", "mouse_position": [1, 2]},
                   {"type": "mouse", "pos": 5}):
            with pytest.raises((ValueError, TypeError)):
                srv.handle_event(ev)
        assert srv.params == before
        srv.params.pack()  # still packable

    def test_frame_payload_bounded_after_shrink(self):
        """Packed frames honor max_points even when capacity >> n_active
        (shrink keeps capacity; the stride must not span the padding)."""
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=5000, method=Method.JNP)
        engine.resize(100)
        pos, rgba = engine.frame_arrays(SimParams(), max_points=50)
        assert pos.shape[1] <= 50
        assert rgba.shape[0] == pos.shape[1]

    def test_raster_wire_mode(self, server):
        """Wire mode 2: the server renders on device and streams the
        RGBA8 framebuffer — wire cost is resolution-bound, not N-bound
        (the 16M-viewing path). Sizes are clamped to [64, 3840] x
        [64, 2160]."""
        s = ws_connect("127.0.0.1", server.port)
        ws_recv_binary(s)
        # fragment brightness is min(2|v|,1) (particle.wgsl:41-44): a
        # freshly generated cloud is static and renders black — turn on
        # gravity so the particles pick up speed and light up
        ws_send_text(s, {"type": "params", "gravity": 5.0})
        ws_send_text(s, {"type": "view", "mode": "raster",
                         "width": 70, "height": 67})
        deadline = time.time() + 20   # 1-core CI box: generous
        mode = 0
        while time.time() < deadline:
            _, frame = ws_recv_binary(s)
            mode = struct.unpack("<I", frame[4:8])[0]
            w, h = (struct.unpack("<II", frame[HDR:HDR + 8])
                    if mode == 2 else (0, 0))
            if mode == 2 and np.frombuffer(
                    frame, np.uint8, offset=HDR + 8).reshape(
                    h, w, 4)[..., :3].max() > 0:
                break
        assert mode == 2
        count = struct.unpack("<I", frame[8:12])[0]
        assert (w, h) == (70, 67)
        assert count == w * h
        assert len(frame) == HDR + 8 + 4 * w * h
        pix = np.frombuffer(frame, np.uint8, offset=HDR + 8).reshape(h, w, 4)
        assert int(pix[..., :3].max()) > 0  # falling sphere is visible
        # camera events steer the server-side viewpoint
        ws_send_text(s, {"type": "camera", "pos": [0, 0, 300.0],
                         "yaw": -1.5707963, "pitch": 0.05, "fov": 1.0})
        deadline = time.time() + 5
        while time.time() < deadline and server.camera.fov != 1.0:
            time.sleep(0.05)
        assert server.camera.fov == 1.0
        assert server.camera.position[2] == 300.0
        # back to point streaming
        ws_send_text(s, {"type": "view", "mode": "planar"})
        deadline = time.time() + 10
        while time.time() < deadline:
            _, frame = ws_recv_binary(s)
            if struct.unpack("<I", frame[4:8])[0] == 0:
                break
        assert struct.unpack("<I", frame[4:8])[0] == 0
        s.close()

    def test_camera_event_rejects_non_finite(self):
        """A NaN pose must fail at event time (reader drops it), not
        render black frames forever."""
        from particle_sim_tpu.app.server import StreamServer
        from particle_sim_tpu.core.params import Method

        engine = Engine(particle_count=1000, method=Method.JNP)
        srv = StreamServer(engine, port=0)
        yaw_before = srv.camera.yaw
        for ev in ({"type": "camera", "yaw": float("nan")},
                   {"type": "camera", "pos": [0.0, float("inf"), 0.0]},
                   {"type": "camera", "fov": "wide"}):
            with pytest.raises(ValueError):
                srv.handle_event(ev)
        assert srv.camera.yaw == yaw_before

    def test_render_frame_device_matches_host(self):
        """Engine.render_frame == fetched render_frame_device (the server
        splits dispatch from fetch to keep the transfer out of the lock)."""
        from particle_sim_tpu.core.params import Method
        from particle_sim_tpu.render.camera import Camera

        engine = Engine(particle_count=1000, method=Method.JNP)
        cam = Camera(aspect=1.0)
        p = SimParams()
        a = engine.render_frame(cam, p, width=64, height=64)
        b = np.asarray(engine.render_frame_device(cam, p, width=64,
                                                  height=64))
        assert a.shape == (64, 64, 4) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
