"""Golden wire-decode test for the JS viewer client.

No JS runtime ships in this image, so the client is pinned two ways:

 1. **Source pinning** — the exact decode expressions the client uses
    (DataView offsets, the record stride, the f16 reads, the paused
    flag bit) are asserted verbatim against offsets COMPUTED from the
    server's ``HEADER_FMT`` / the packer's ``RECORD_BYTES``. Any change
    to either side of the wire contract fails here until both move
    together.
 2. **Mirror decode** — a literal Python transcription of the client's
    ``handleFrame``/``f16`` (same reads, same arithmetic) decodes
    frames built by the server's own packing math (header via
    ``HEADER_FMT``, payloads via ``packer.pack_f16`` / planar /
    raster bytes — the `_build_frame` layout, server.py:319-334) and
    must reproduce the ground-truth arrays. The JS ``f16`` algebra is
    additionally checked against IEEE half (numpy float16) over every
    one of the 65536 bit patterns.
"""

import os
import struct

import numpy as np

from particle_sim_tpu.app import server as server_mod
from particle_sim_tpu.io import packer

VIEWER = os.path.join(os.path.dirname(server_mod.__file__),
                      "viewer", "index.html")


def _header_offsets():
    """Field byte offsets of HEADER_FMT, computed not hard-coded."""
    fmt = server_mod.HEADER_FMT
    assert fmt[0] == "<"
    offs, off = [], 0
    for ch in fmt[1:]:
        offs.append(off)
        off += struct.calcsize(ch)
    return offs  # magic, mode, count, frame_id, total, fps, upd,
    #              rseq, slat, flags


def test_client_decode_source_pinned():
    src = open(VIEWER).read()
    (o_magic, o_mode, o_count, _o_fid, o_total, o_fps, o_upd,
     o_rseq, o_slat, o_flags) = _header_offsets()
    hdr = server_mod.HEADER_BYTES
    rec = packer.RECORD_BYTES
    pins = [
        f"dv.getUint32({o_magic},true)!==0x{server_mod.MAGIC:X}",
        f"mode=dv.getUint32({o_mode},true)",
        f"count=dv.getUint32({o_count},true)",
        f"total=dv.getUint32({o_total},true)",
        f"sfps=dv.getFloat32({o_fps},true)",
        f"upd=dv.getFloat32({o_upd},true)",
        f"rseq=dv.getUint32({o_rseq},true)",
        f"slat=dv.getFloat32({o_slat},true)",
        f"flags=dv.getUint32({o_flags},true)",
        f"const off={hdr};",
        # f16 record layout: x/y/z halves then 4 color bytes
        f"f16(rec.getUint16(i*{rec},true))",
        f"f16(rec.getUint16(i*{rec}+2,true))",
        f"f16(rec.getUint16(i*{rec}+4,true))",
        f"rec.getUint8(i*{rec}+6)",
        f"rec.getUint8(i*{rec}+9)",
        # planar layout: f32[3n] then u8[4n]
        "new Float32Array(buf,off,3*count)",
        "new Uint8Array(buf,off+12*count,4*count)",
        # raster layout: w, h u32 then rgba8
        "dv.getUint32(off,true)",
        "dv.getUint32(off+4,true)",
        "new Uint8Array(buf,off+8,4*w*h)",
        # paused flag bit (server FLAG_PAUSED == 1<<0)
        "(flags&1)?",
    ]
    assert server_mod.FLAG_PAUSED == 1
    for pin in pins:
        assert pin in src, f"viewer decode drifted from the wire "\
                           f"contract: missing {pin!r}"


# --- literal Python mirror of the client's decode ------------------------

def _js_f16(bits):
    """Vectorized transcription of the viewer's f16() (index.html)."""
    bits = np.asarray(bits, dtype=np.uint32)
    s = np.where(bits & 0x8000, -1.0, 1.0)
    e = (bits >> 10) & 0x1F
    m = (bits & 0x3FF).astype(np.float64)
    sub = s * m * 2.0 ** -24
    with np.errstate(invalid="ignore"):
        inf = np.where(m > 0, np.nan, s * np.inf)
    norm = s * (1.0 + m / 1024.0) * np.exp2(e.astype(np.float64) - 15.0)
    return np.where(e == 0, sub, np.where(e == 31, inf, norm))


def _js_handle_frame(buf: bytes):
    u32 = lambda off: struct.unpack_from("<I", buf, off)[0]
    f32 = lambda off: struct.unpack_from("<f", buf, off)[0]
    (o_magic, o_mode, o_count, _o_fid, o_total, o_fps, o_upd,
     o_rseq, o_slat, o_flags) = _header_offsets()
    assert u32(o_magic) == server_mod.MAGIC
    mode, count = u32(o_mode), u32(o_count)
    out = {"mode": mode, "count": count, "total": u32(o_total),
           "sfps": f32(o_fps), "upd": f32(o_upd), "rseq": u32(o_rseq),
           "slat": f32(o_slat), "paused": bool(u32(o_flags) & 1)}
    off = server_mod.HEADER_BYTES
    if mode == 2:
        w, h = u32(off), u32(off + 4)
        out.update(w=w, h=h,
                   pix=np.frombuffer(buf, np.uint8, 4 * w * h, off + 8))
        return out
    if mode == 0:
        pos = np.frombuffer(buf, np.float32, 3 * count, off)
        col = np.frombuffer(buf, np.uint8, 4 * count, off + 12 * count)
    else:
        rec = buf[off:]
        stride = packer.RECORD_BYTES
        pos = np.empty(3 * count, np.float32)
        col = np.empty(4 * count, np.uint8)
        for i in range(count):            # the client's literal loop
            for k in range(3):
                bits = struct.unpack_from("<H", rec, i * stride + 2 * k)[0]
                pos[k * count + i] = _js_f16(bits)
            for k in range(4):
                col[i * 4 + k] = rec[i * stride + 6 + k]
    out.update(pos=pos.reshape(3, count), col=col.reshape(count, 4))
    return out


def _frame(mode, payload, count, total=1234, fps=59.9, upd=1.5,
           rseq=7, slat=3.25, paused=True):
    head = struct.pack(server_mod.HEADER_FMT, server_mod.MAGIC, mode,
                       count, 42, total, fps, upd, rseq, slat,
                       server_mod.FLAG_PAUSED if paused else 0)
    return head + payload


def test_js_f16_matches_ieee_half_exhaustively():
    bits = np.arange(65536, dtype=np.uint16)
    ieee = bits.view(np.float16).astype(np.float64)
    js = _js_f16(bits)
    np.testing.assert_array_equal(np.isnan(js), np.isnan(ieee))
    ok = ~np.isnan(ieee)
    np.testing.assert_array_equal(js[ok], ieee[ok])


def test_mirror_decode_f16_mode():
    rng = np.random.default_rng(3)
    n = 64
    pos = (rng.normal(size=(3, n)) * 40).astype(np.float32)
    rgba = rng.integers(0, 256, (n, 4)).astype(np.uint8)
    payload = packer.pack_f16(pos, rgba).tobytes()
    got = _js_handle_frame(_frame(1, payload, n))
    assert got["paused"] and got["rseq"] == 7 and got["total"] == 1234
    np.testing.assert_allclose(got["slat"], 3.25)
    # the client must recover exactly the f16-quantized positions
    np.testing.assert_array_equal(
        got["pos"], pos.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(got["col"], rgba)


def test_mirror_decode_planar_mode():
    rng = np.random.default_rng(4)
    n = 96
    pos = (rng.normal(size=(3, n)) * 40).astype(np.float32)
    rgba = rng.integers(0, 256, (n, 4)).astype(np.uint8)
    payload = pos.tobytes() + rgba.tobytes()
    got = _js_handle_frame(_frame(0, payload, n, paused=False))
    assert not got["paused"]
    np.testing.assert_array_equal(got["pos"], pos)
    np.testing.assert_array_equal(got["col"], rgba)


def test_mirror_decode_raster_mode():
    rng = np.random.default_rng(5)
    w, h = 16, 8
    fb = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    payload = struct.pack("<II", w, h) + fb.tobytes()
    got = _js_handle_frame(_frame(2, payload, w * h))
    assert (got["w"], got["h"]) == (w, h)
    np.testing.assert_array_equal(got["pix"].reshape(h, w, 4), fb)


def test_raster_mode_golden_frame():
    """The raster path's PIXELS are pinned, not just its packets. A fixed
    scene rendered through render/raster.py (the engine's one
    rasterizer), wrapped in the exact mode-2 wire layout and decoded by
    the JS-mirror decode, must match the stored golden frame
    (tests/data/golden_raster_256x128.npz, velocity-brightness shading,
    particle.wgsl:38-45 semantics). Tolerance: a few u8 levels, for
    accumulation-order float differences of the scatter-add."""
    import jax.numpy as jnp

    from particle_sim_tpu.core import generate as G
    from particle_sim_tpu.core.params import SimParams
    from particle_sim_tpu.core.state import ParticleState
    from particle_sim_tpu.render import raster
    from particle_sim_tpu.render.camera import Camera

    w, h = 256, 128
    pos, vel, col = G.generate(3000, G.SphereGeneration.HOLLOW)
    vel = (pos * 0.02).astype(np.float32)   # brightness = min(2|v|, 1)
    st = ParticleState.from_arrays(pos, vel, col)
    pv = jnp.asarray(SimParams().pack())
    vp = jnp.asarray(Camera(aspect=w / h).view_proj())
    fb = raster.render(st.pos, st.vel, st.init_color, pv, vp,
                       st.n_active, width=w, height=h)
    rgba = np.asarray(raster.to_rgba8(fb))
    payload = struct.pack("<II", w, h) + rgba.tobytes()
    got = _js_handle_frame(_frame(2, payload, w * h))
    pix = got["pix"].reshape(h, w, 4)

    golden = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "golden_raster_256x128.npz"))["rgba"]
    assert pix.shape == golden.shape
    assert (golden[..., :3].sum(-1) > 0).sum() > 2000  # not vacuous
    diff = np.abs(pix.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 3, f"raster pixels drifted: max {diff.max()}"
