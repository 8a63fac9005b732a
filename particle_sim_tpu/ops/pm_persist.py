"""Persistent cell-ordered PM state — the sort-free particle-mesh frame.

The per-frame solver (ops/pm.py) deposits and gathers in identity order.
This module keeps the particles in (approximately) cell-sorted STORAGE
order as part of the simulation state instead, with identity riding along
as an ``ids`` payload (colors / streaming / on-demand un-sort are a
gather by ``ids`` at the consumer's expense, not the frame's):

  * every frame deposits and gathers through the same XLA CIC transfer as
    the per-frame path (pm.cic_deposit / pm.cic_gather), fed from the
    slot-order cell coords — order never changes the result, only the
    memory locality of the scatter and the gather, so the frame is exact
    in any order;
  * per-chunk cell-row SPANS of the keys measure how far the order has
    drifted from sorted (a reshape min/max at O(N) bandwidth); when the
    pair counts they imply exceed a static budget, a ``lax.cond``
    repairs the order — in TWO TIERS at large N: tier 1 is a
    SEGMENT-LOCAL grouping sort (rows of an (n/seg, seg) reshape sort
    independently), tier 2 falls back to the FULL sort (pos, vel,
    ids[, masses][, col24]) when the local repair did not bring the
    totals under budget (see pick_segment / accel_sorted). Pass
    ``two_tier=False`` to skip tier 1 for scenes whose bulk motion
    crosses segments. ``resorts`` counts repair PASSES (a frame that
    needed both tiers counts 2).

Whether cell order pays for its repairs through cache locality is a
benchmark question; the order and its repair cadence are kept whole so it
can be measured.

Static-box modes only (periodic / isolated): ``auto_box`` re-keys every
particle every frame (the box tracks the cloud), which defeats span
locality — use the per-frame path (pm.pm_accel_ref) there.

Two-level mode (``cfg2``, ops/pm2.py) extends the order to the fine level
via the SEGMENTED order: the repair sort keys non-window particles by
coarse cell id and the window(+parking band) members by FINE cell id (the
tail segment, boundary ``fine_b`` in the state), with membership FROZEN
between repairs. Fine order is a monotone refinement of coarse order
inside the window, so segment B is coherent for BOTH levels. Leavers just
stop depositing (zero source weight); a true entrant — a frozen-A particle
reaching the source set, which first has to cross the parking band
(cfg2.park) — forces a repair that frame.

Reference parity: same physics contract as ops/pm.step_pm_ref /
reference compute.wgsl integration (see ops/physics.py citations); the
reference app has no self-gravity at all — this path is a capability
extension checked against pm.pm_accel_ref.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import params as P
from ..core.state import LANE
from ..utils.search import bin_search as _bin_search
from . import physics, pm

# The disorder measure counts, per chunk of slots, the cell-row windows
# (T_ROWS rows each) and gather tiles (T_ROWS_G rows each) its row span
# touches — the pair counts of a tiled CIC transfer over that order. No
# transfer on this path is tiled: the XLA scatter and gather are exact in
# any order, so these counts and the budgets below set only the repair
# cadence, which has not been tuned on the GPU.
T_ROWS = 32
T_ROWS_G = 16
SUPPORTED_GRIDS = (32, 64, 128, 256)


class _Geom(NamedTuple):
    """Per-grid-size row layout of the disorder measure."""
    g: int            # cells per axis; cell id = (z*g + y)*g + x
    shift: int        # log2(g): row = key >> shift
    rows_total: int   # g*g rows of g cells each
    n_tiles: int      # T_ROWS-row windows
    n_tiles_g: int    # T_ROWS_G-row gather tiles
    sentinel: int     # g^3: cell id past the last (dead particles)


@functools.lru_cache(maxsize=None)
def _geom(g: int) -> _Geom:
    if g not in SUPPORTED_GRIDS:
        raise ValueError(f"persistent PM supports grids {SUPPORTED_GRIDS}, "
                         f"got {g}")
    rows = g * g
    return _Geom(g, g.bit_length() - 1, rows, rows // T_ROWS,
                 rows // T_ROWS_G, g * g * g)


_GEOM128 = _geom(128)


def cell_key(pos_flat: jax.Array, live: jax.Array, cfg: "P.PMConfig",
             coords=None) -> jax.Array:
    """i32[N] flattened cell id (z*G + y)*G + x of each particle; entries
    where ``live`` (bool[N]) is False become the geometry's sentinel G^3.
    ``coords`` overrides the cell coords (refinement windows)."""
    geom = _geom(cfg.grid)
    g = geom.g
    c = pm.cell_coords(pos_flat, cfg) if coords is None else coords
    i0 = jnp.minimum(jnp.floor(c), jnp.float32(g - 1)).astype(jnp.int32)
    key = (i0[2] * g + i0[1]) * g + i0[0]
    return jnp.where(live, key, geom.sentinel)


# Pair budgets, in window-memberships / tile-visits x2 per chunk, PER GRID
# GEOMETRY. Freshly repaired order needs <= 4 + o(1) of either; the
# headroom above that is how much drift a state absorbs before the next
# forced repair. ONE particle crossing a z-cell boundary widens its whole
# chunk's row span by G rows (G/T_ROWS extra windows per side), so a
# useful budget absorbs at least +-1 z-cell of outlier drift, or dense
# states repair almost every frame.


def _slack(geom) -> Tuple[int, int]:
    """(deposit, gather) per-chunk pair budgets for ``geom`` — the
    +-1-z-cell sizing (comment above): a fixed base plus the windows /
    tile-visits one cell of drift adds at this grid (20, 24 at G=128)."""
    return (12 + 2 * (geom.g // T_ROWS), 8 + 2 * (geom.g // T_ROWS_G))


# Cap on a budget: past it the order is considered too scattered to keep.
_MAX_PAIRS = 65536


def pick_segment(n_pad: int, chunk: int) -> int:
    """Slots per LOCAL-repair segment (0 = no local tier, see
    accel_sorted). A segment-local repair sorts rows of an
    (n/seg, seg) reshape independently — a much shallower sort than
    the global one — and preserves every invariant the global sort
    establishes *within* each segment (dead slots keep to the global
    tail: their keys are maximal and they already occupy the trailing
    segments). Segments must hold
    >= 8 chunks (so per-chunk spans re-telescope after the local sort)
    and >= 32768 slots (below that, particles cross segment boundaries
    too readily for the local tier to pay — small-N states skip it)."""
    for s in (65536, 32768):
        if (n_pad % s == 0 and s % chunk == 0 and s // chunk >= 8
                and n_pad // s >= 4):
            return s
    return 0


def pick_chunk(n_pad: int, geom=_GEOM128) -> int:
    """Slots per span chunk: smallest supported chunk whose
    SLACK-scaled worst-case pair counts stay within _MAX_PAIRS. A
    capacity no such chunk divides (an odd multiple of 512 or 1024 at
    millions of particles) takes the largest chunk that divides it: its
    budgets clamp to _MAX_PAIRS, which only shortens the drift headroom
    between repairs — the transfer is exact in any order."""
    if n_pad % 512:
        raise ValueError(f"capacity {n_pad} not a multiple of 512")
    sd, sg = _slack(geom)
    fits = []
    for c in (512, 1024, 2048, 4096, 8192, 16384):
        if n_pad % c:
            continue
        fits.append(c)
        nc = n_pad // c
        worst = max(sd * nc + 4 * geom.n_tiles,
                    sg * nc + 2 * geom.n_tiles_g) + 2
        if worst <= _MAX_PAIRS:
            return c
    return fits[-1]


def budgets(n_chunks: int, geom=_GEOM128) -> Tuple[int, int]:
    """(c_max_dep, c_max_gat) repair thresholds: DOUBLE the +-1-cell
    SLACK sizing, clamped to _MAX_PAIRS — drift headroom that stretches
    the repair cadence for dynamic scenes. A fresh sort's totals sit at
    the telescoping bound (~SLACK/2 per chunk), far below either."""
    sd, sg = _slack(geom)
    return (min(2 * sd * n_chunks + 4 * geom.n_tiles + 2, _MAX_PAIRS),
            min(2 * sg * n_chunks + 2 * geom.n_tiles_g + 2, _MAX_PAIRS))


# sort-key classes of the SEGMENTED order (two-level mode): live
# non-window particles sort by coarse key (< sentinel = g^3 < seg flag
# = 2 g^3), frozen-window-member particles by 2 g^3 + fine key, dead
# slots last (4 g^3). fine_b = count of class-A slots = the frozen
# segment boundary. Flags scale with the geometry so G=256's 2^24 keys
# still classify (i32 headroom: 4 g^3 <= 2^26).
def _seg_flag(geom) -> int:
    return 2 * geom.sentinel


def _dead_key(geom) -> int:
    return 4 * geom.sentinel


class SortedPMState(NamedTuple):
    """Particle state in (approximately) cell-sorted storage order.

    ``fine_b`` (i32 scalar; i32[k] in the MULTI-level mode, see
    init_sorted_multi / accel_sorted_multi) is the two-level mode's frozen segment
    boundary: slots [0, fine_b) hold non-window particles in coarse
    cell order, slots [fine_b, N) hold the window(+park) members of the
    last repair in FINE cell order (then dead slots). fine_b == N means
    no fine segment (coarse-only states, fresh inits).

    ``col24`` (optional i32 (N,), 8:8:8-packed generation color in slot
    order) lets every DISPLAY consumer — rasterizer, stream packer —
    serve color mode 0 (ORIGINAL, the reference default,
    compute.wgsl:75-77) straight from the sorted planes: without it the
    default-color interactive frame pays a full identity-order rebuild
    per consumed frame, where carrying it costs one more operand per
    repair sort. u8 per channel matches the wire format's own color
    quantization."""
    pos: jax.Array              # f32 (3, N)
    vel: jax.Array              # f32 (3, N)
    ids: jax.Array              # i32 (N,) original identity of each slot
    masses: Optional[jax.Array]  # f32 (N,) source masses in slot order
    resorts: jax.Array          # i32 scalar: cumulative repair count
    fine_b: Optional[jax.Array] = None   # i32 scalar (or [k]) boundary
    col24: Optional[jax.Array] = None    # i32 (N,) packed display color


def _sort_state(key, pos, vel, ids, masses, resorts,
                fine_b=None, col24=None, seg: int = 0) -> SortedPMState:
    """Grouping sort into a SortedPMState. ``seg`` > 0 sorts each
    ``seg``-slot segment INDEPENDENTLY (rows of a reshape — the local
    repair tier, see pick_segment) instead of globally."""
    ops = (key, pos[0], pos[1], pos[2], vel[0], vel[1], vel[2], ids)
    if masses is not None:
        ops += (masses,)
    if col24 is not None:
        ops += (col24,)
    if seg:
        ops = tuple(o.reshape(-1, seg) for o in ops)
    s = jax.lax.sort(ops, num_keys=1)
    if seg:
        s = tuple(o.reshape(-1) for o in s)
    k = 8
    m_s = s[k] if masses is not None else None
    k += masses is not None
    c_s = s[k] if col24 is not None else None
    return SortedPMState(jnp.stack(s[1:4]), jnp.stack(s[4:7]), s[7],
                         m_s, resorts, fine_b, c_s)


def init_sorted(pos_flat: jax.Array, n_active, cfg: "P.PMConfig",
                vel_flat=None, masses=None, col24=None) -> SortedPMState:
    """Full grouping sort of (pos, vel, identity[, masses][, col24])
    into a fresh SortedPMState. ``n_active`` masks trailing padding
    slots (their keys become the sentinel, so they sort to the tail with
    ids >= n_active). The state starts coarse-only (fine_b == N); the
    two-level mode's first accel_sorted call migrates it into the
    segmented order with one repair (see accel_sorted). ``col24`` is
    the optional packed display color (see SortedPMState)."""
    n = pos_flat.shape[1]
    if n % 512:
        raise ValueError(f"particle capacity {n} not a multiple of 512")
    if cfg.auto_box:
        raise ValueError("persistent sorted mode needs a static box; "
                         "use pm.pm_accel_ref for auto_box")
    _geom(cfg.grid)   # raises for grids outside SUPPORTED_GRIDS
    ids = jnp.arange(n, dtype=jnp.int32)
    key = cell_key(pos_flat, ids < n_active, cfg)
    vel_flat = (jnp.zeros_like(pos_flat) if vel_flat is None
                else jnp.asarray(vel_flat))
    return _sort_state(key, pos_flat, vel_flat, ids, masses, jnp.int32(0),
                       jnp.int32(n), col24)


def _chunk_spans(key: jax.Array, chunk: int, geom=_GEOM128):
    """(rmin i32[n_chunks], rmax i32[n_chunks]) grid-row span per chunk
    over the chunk's LIVE keys only: sentinel entries (dead slots, or
    masked-out particles on the fine level) are excluded — rmin falls
    back to rows_total and rmax to -1, so an all-masked chunk reads as
    EMPTY (rmax < rmin) and intersects no window, instead of a sentinel
    rmax inflating the prefix-max hull to every window above it."""
    r = (key >> geom.shift).reshape(-1, chunk)
    dead = key.reshape(-1, chunk) >= geom.sentinel
    rmin = jnp.where(dead, geom.rows_total, r).min(axis=1)
    rmax = jnp.where(dead, -1, r).max(axis=1)
    return rmin, rmax


def _hull(rmin, rmax, n_chunks: int, geom=_GEOM128):
    """(s_lo, s_hi) inclusive chunk hull per deposit window w = 2t + fam
    (s_hi < s_lo = empty).

    Window w = 2t + fam accepts base rows [lo_w, hi_w]: fam 0 (corner
    rows r, r+1) base rows [t*T_ROWS - 1, (t+1)*T_ROWS - 1], fam 1
    (corner rows r+G, r+G+1) the same range shifted down G rows.
    min{s: rmax_s >= lo} equals the first index where the running
    prefix-max of rmax reaches lo, and max{s: rmin_s <= hi} the last index
    where the suffix-min of rmin stays <= hi — both monotone, so two binary
    searches give the EXACT contiguous hull of intersecting chunks. lo is
    clamped to 0 (no negative rows exist) so EMPTY chunks (rmax == -1) can
    never satisfy the lo test — required by the segmented counts, where a
    masked-out segment's chunks must not leak into the other segment's
    hulls."""
    n_iters = max(n_chunks, 2).bit_length() + 1
    m_pre = jax.lax.cummax(rmax)                          # nondecreasing
    m_suf = jax.lax.cummin(rmin, reverse=True)            # nondecreasing
    w_idx = jnp.arange(2 * geom.n_tiles, dtype=jnp.int32)
    t_w = w_idx >> 1
    fam_w = w_idx & 1
    lo_r = jnp.maximum(
        t_w * T_ROWS - jnp.where(fam_w == 1, geom.g + 1, 1), 0)
    hi_r = (t_w + 1) * T_ROWS - jnp.where(fam_w == 1, geom.g, 0) - 1
    s_lo = _bin_search(m_pre, lo_r, side_right=False, n_iters=n_iters)
    s_hi = _bin_search(m_suf, hi_r, side_right=True, n_iters=n_iters) - 1
    return s_lo.astype(jnp.int32), s_hi.astype(jnp.int32)


def _window_ranges(rmin, rmax, n_chunks: int, geom=_GEOM128):
    """Per deposit window: (start chunk, count, empty mask) — the
    single-hull expansion (empty windows count one entry)."""
    s_lo, s_hi = _hull(rmin, rmax, n_chunks, geom)
    empty = s_hi < s_lo
    c_w = jnp.where(empty, 1, s_hi - s_lo + 1).astype(jnp.int32)
    start = jnp.where(empty, n_chunks, s_lo).astype(jnp.int32)
    return start, c_w, empty


def _seg_spans(key: jax.Array, chunk: int, fine_b, geom=_GEOM128):
    """Per-segment chunk spans of the SEGMENTED order: slots < fine_b
    (segment A, coarse-ordered) and slots >= fine_b (segment B,
    fine-ordered window members + dead tail), masked per SLOT so the one
    boundary chunk contributes its A-part to A and B-part to B."""
    slot = jnp.arange(key.shape[0], dtype=jnp.int32)
    key_a = jnp.where(slot < fine_b, key, geom.sentinel)
    key_b = jnp.where(slot < fine_b, geom.sentinel, key)
    return (_chunk_spans(key_a, chunk, geom),
            _chunk_spans(key_b, chunk, geom))


def _window_ranges_seg(spans_a, spans_b, n_chunks: int, geom=_GEOM128):
    """Per deposit window: (startA, cA, startB, cB) — TWO hulls, one per
    segment of the segmented order. A single global hull over the mixed
    order would stretch from mid-A to the B tail for every window whose
    rows intersect the physical refinement window, ballooning the pair
    count ~O(n_chunks); per-segment hulls stay tight. The boundary chunk
    can appear in both hulls (its A-part rows and B-part rows both
    matching) — the duplicate is trimmed off B so no pair counts twice.
    Windows empty in both segments count one entry in A."""
    lo_a, hi_a = _hull(*spans_a, n_chunks, geom)
    lo_b, hi_b = _hull(*spans_b, n_chunks, geom)
    c_a = jnp.maximum(hi_a - lo_a + 1, 0)
    c_b = jnp.maximum(hi_b - lo_b + 1, 0)
    # overlap is structurally confined to the boundary chunk: hull A
    # cannot extend past it (A spans above it are EMPTY), hull B cannot
    # start before it
    dup = ((c_a > 0) & (c_b > 0) & (hi_a >= lo_b)).astype(jnp.int32)
    lo_b = lo_b + dup
    c_b = c_b - dup
    pad = (c_a + c_b) == 0
    start_a = jnp.where(pad, n_chunks, lo_a).astype(jnp.int32)
    c_a = jnp.where(pad, 1, c_a).astype(jnp.int32)
    return start_a, c_a, lo_b.astype(jnp.int32), c_b.astype(jnp.int32)


def _gather_tiles(rmin, rmax, geom=_GEOM128):
    """(t_lo, t_hi) inclusive fam-0 tile range per chunk (corner rows are
    r and r+1, so the top tile comes from rmax + 1) — in the gather's OWN
    row blocking (T_ROWS_G)."""
    t_lo = jnp.clip(rmin // T_ROWS_G, 0,
                    geom.n_tiles_g - 1).astype(jnp.int32)
    t_hi = jnp.clip((rmax + 1) // T_ROWS_G, 0,
                    geom.n_tiles_g - 1).astype(jnp.int32)
    return t_lo, jnp.maximum(t_hi, t_lo)


def _fine_inputs(pos, live, wmin, cfg: "P.PMConfig", cfg2):
    """(w_src f32[N], key2 i32[N]) for the fine level in the caller's
    slot order, given the window origin ``wmin`` (computed ONCE per
    frame by the caller — it is order-invariant, so it must not be
    re-derived inside per-shard repair branches, where a collective
    would deadlock shards that took the other branch). Non-window /
    dead particles get the sentinel key (outside every masked span);
    w_src is the window's source mask. Purely local/elementwise."""
    from . import pm2 as _pm2
    h2 = cfg2.window_size / cfg.grid
    coords2 = pm.cell_coords_dyn(pos, wmin, h2, cfg.grid)
    inner = _pm2._in_window(pos, wmin, cfg2.window_size, cfg2.margin) & live
    return (inner.astype(jnp.float32),
            cell_key(pos, inner, cfg, coords=coords2))


def _pair_totals(key: jax.Array, chunk: int, geom=_GEOM128):
    """(dep_total, gat_total) pair counts of a tiled CIC transfer over
    this order — the traced disorder measure checked against the static
    budgets to trigger a repair."""
    n_chunks = key.shape[0] // chunk
    rmin, rmax = _chunk_spans(key, chunk, geom)
    _, c_w, _ = _window_ranges(rmin, rmax, n_chunks, geom)
    t_lo, t_hi = _gather_tiles(rmin, rmax, geom)
    return c_w.sum(), (2 * (t_hi - t_lo + 1)).sum()


def _pair_totals_seg(key: jax.Array, chunk: int, fine_b, geom=_GEOM128):
    """(dep_total, gat_total) for the segmented coarse order — the
    deposit total sums BOTH segments' hulls; the gather count stays
    chunk-major over the full spans (order-agnostic)."""
    n_chunks = key.shape[0] // chunk
    spans_a, spans_b = _seg_spans(key, chunk, fine_b, geom)
    _, c_a, _, c_b = _window_ranges_seg(spans_a, spans_b, n_chunks, geom)
    rmin, rmax = _chunk_spans(key, chunk, geom)
    t_lo, t_hi = _gather_tiles(rmin, rmax, geom)
    return (c_a + c_b).sum(), (2 * (t_hi - t_lo + 1)).sum()


# ---------------------------------------------------------------------------
# MULTI-segment order (k nested refinement levels)
# ---------------------------------------------------------------------------
#
# The two-level segmented order generalizes to k levels with k+1 classes:
# class 0 = live non-members (coarse cell order), class m (1 <= m <= k) =
# frozen members of window m but not window m+1 (level-m cell order),
# dead slots last. ``fine_b`` becomes an i32[k] vector of class-start
# slots: class m occupies [fine_b[m-1], fine_b[m]) (fine_b[k-1] .. N for
# the innermost class + dead tail). The key properties carry over:
#   * classes are CONTIGUOUS and ordered, so per-class hulls are tight
#     and any two hulls overlap only at shared boundary chunks (a class
#     small enough to sit inside one chunk just collapses its hull onto
#     that chunk — the cumulative-max dedup below handles chains);
#   * level-m counts mask keys outside classes >= m (slot < fine_b[m-1]
#     -> sentinel): post-repair every level-m source lives in classes
#     >= m (class = INNERMOST park-shrunk window containing the
#     particle, and sources of level m sit inside window m's
#     margin-shrunk mask which the park band strictly contains), so the
#     mask is exact; a pre-repair entrant forces the repair that frame.


def budgets_multi(n_chunks: int, geom, n_classes: int) -> Tuple[int, int]:
    """budgets() scaled for the k+1-class order: each window's deposit
    entries split across up to n_classes per-class hulls, and a class
    sorted by a FINER level's key has non-telescoping spans at coarser
    levels (a level-m chunk covers its whole window extent in level-l
    coordinates for l < m: a fresh 3-class state needs ~1.3x the
    2-class gather budget), so both the slack and the per-window base
    terms scale with the class count. Clamped to _MAX_PAIRS: past the
    clamp (deep nesting at very large N) a fresh state can sit over its
    own budget and repair every frame — slower, never wrong, since the
    transfer is exact in any order."""
    sd, sg = _slack(geom)
    return (min(n_classes * (2 * sd * n_chunks + 4 * geom.n_tiles) + 2,
                _MAX_PAIRS),
            min(n_classes * (2 * sg * n_chunks + 2 * geom.n_tiles_g) + 2,
                _MAX_PAIRS))


def _seg_spans_multi(key: jax.Array, chunk: int, bounds: jax.Array,
                     geom=_GEOM128, first_class: int = 0):
    """Per-CLASS chunk spans of the multi-segment order. ``bounds``
    i32[k] are the class-start slots (see section comment); returns
    k+1 span pairs, masked per SLOT so a boundary chunk contributes
    each part to its own class. ``first_class``: classes below it are
    known all-sentinel in ``key`` (a level-m fine key masks classes
    <= m), so their spans are the EMPTY constant — skipping the O(N)
    masking pass per skipped class."""
    n = key.shape[0]
    slot = jnp.arange(n, dtype=jnp.int32)
    k = bounds.shape[0]
    lo = [jnp.int32(0)] + [bounds[m] for m in range(k)]
    hi = [bounds[m] for m in range(k)] + [jnp.int32(n)]
    out = []
    empty = (jnp.full((n // chunk,), geom.rows_total, jnp.int32),
             jnp.full((n // chunk,), -1, jnp.int32))
    for m in range(k + 1):
        if m < first_class:
            out.append(empty)
            continue
        key_m = jnp.where((slot >= lo[m]) & (slot < hi[m]), key,
                          geom.sentinel)
        out.append(_chunk_spans(key_m, chunk, geom))
    return out


def _window_ranges_multi(spans, n_chunks: int, geom=_GEOM128):
    """Per deposit window: (starts, counts) lists, one entry per class —
    per-class hulls with cumulative boundary-chunk dedup (a chunk
    already covered by an earlier class's hull is trimmed off the next
    hull's start; hull intervals are contiguous and class chunk ranges
    are ordered, so trimmed chunks are exactly the already-covered
    ones). Windows empty in EVERY class get one PAD entry in class 0."""
    starts, counts = [], []
    cum_hi = None
    for sp in spans:
        lo, hi = _hull(*sp, n_chunks, geom)
        if cum_hi is not None:
            lo = jnp.maximum(lo, cum_hi + 1)
        c = jnp.maximum(hi - lo + 1, 0)
        seg_hi = jnp.where(c > 0, hi, -1)
        cum_hi = seg_hi if cum_hi is None else jnp.maximum(cum_hi, seg_hi)
        starts.append(lo.astype(jnp.int32))
        counts.append(c.astype(jnp.int32))
    total = counts[0]
    for c in counts[1:]:
        total = total + c
    pad = total == 0
    starts[0] = jnp.where(pad, n_chunks, starts[0]).astype(jnp.int32)
    counts[0] = jnp.where(pad, 1, counts[0]).astype(jnp.int32)
    return starts, counts


def _pair_totals_multi(key: jax.Array, chunk: int, bounds: jax.Array,
                       geom=_GEOM128, first_class: int = 0):
    """(dep_total, gat_total) for the multi-segment order — deposit
    sums every class's hulls; the gather count stays chunk-major over
    the full spans (order-agnostic). ``first_class`` as in
    _seg_spans_multi."""
    n_chunks = key.shape[0] // chunk
    spans = _seg_spans_multi(key, chunk, bounds, geom, first_class)
    _, counts = _window_ranges_multi(spans, n_chunks, geom)
    total = counts[0]
    for c in counts[1:]:
        total = total + c
    rmin, rmax = _chunk_spans(key, chunk, geom)
    t_lo, t_hi = _gather_tiles(rmin, rmax, geom)
    return total.sum(), (2 * (t_hi - t_lo + 1)).sum()


def _momentum_clean_live(acc, live_f, masses, psum_axis=None):
    """pm.momentum_clean with an explicit live mask (slot order is not
    identity order here, so ``arange < n_active`` would mask the wrong
    slots). With ``psum_axis`` the mean is global over the mesh axis
    (multi-device momentum conservation, parallel/pm_dp.py:101-114)."""
    w = live_f if masses is None else live_f * masses
    s = (acc * w[None]).sum(axis=1, keepdims=True)
    c = w.sum()
    if psum_axis is not None:
        s = jax.lax.psum(s, psum_axis)
        c = jax.lax.psum(c, psum_axis)
    return (acc - s / jnp.maximum(c, 1e-12)) * live_f[None]


def _transfer(st: SortedPMState, live, cfg: "P.PMConfig", base_kernels,
              psum_axis):
    """f32[3, N] coarse-level acceleration (unit G, before the momentum
    clean) in slot order: XLA deposit -> [grid psum] -> solve -> gather."""
    c = pm.cell_coords(st.pos, cfg)
    wrap = cfg.boundary == "periodic"
    m = live.astype(jnp.float32)
    if st.masses is not None:
        m = m * st.masses
    rho = pm.cic_deposit(c, m, cfg.grid, wrap)
    if psum_axis is not None:
        rho = jax.lax.psum(rho, psum_axis)
    grids = pm.solve_accel(rho, cfg, cfg.softening, kernels=base_kernels)
    return pm.cic_gather(grids, c, cfg.grid, wrap)


def accel_sorted(st: SortedPMState, g_const, cfg: "P.PMConfig", *,
                 n_active=None, chunk: int = 0, psum_axis=None, cfg2=None,
                 kernels=None, base_kernels=None, two_tier: bool = True
                 ) -> Tuple[SortedPMState, jax.Array]:
    """(state', acc f32[3, N]) — PM acceleration in the state's slot
    order, repairing the order first iff drift exceeds the pair budgets.
    Traceable; the returned state is the one ``acc`` aligns with
    (reordered when a repair fired, ``resorts`` incremented).

    Inside a shard_map, pass ``psum_axis`` (the dp mesh axis): the state
    is then the SHARD's locally-ordered particles (global ids), the local
    mass grid is psum'd before the replicated solve — the only collective,
    O(G^3) like parallel/pm_dp.py — the gather stays local, and repairs
    fire per shard independently (particles never migrate between
    shards).

    ``cfg2`` (a pm2.PM2Config, with ``kernels`` from pm2.fine_kernels)
    adds the two-level refinement window on top, via the SEGMENTED order:
    repairs sort by a class key — non-window particles by coarse cell id,
    the window(+park) members of THAT moment by FINE cell id (slots
    [fine_b, N)), dead slots last. Membership is FROZEN at repair time
    behind a parking band (cfg2.park): leavers just stop depositing,
    band-crossers are outside the source set by construction, and a TRUE
    entrant — a frozen-A particle reaching the source set — forces a
    repair that frame. The fine level itself is pm2.fine_accel on the
    slot order. Multi-device (psum_axis): the window origin is global (one
    4-scalar psum) and the fine grid joins the coarse grid's psum."""
    if cfg.auto_box:
        raise ValueError("persistent sorted mode needs a static box; "
                         "use pm.pm_accel_ref for auto_box")
    geom = _geom(cfg.grid)   # raises for grids outside SUPPORTED_GRIDS
    n = st.pos.shape[1]
    n_active = jnp.int32(n) if n_active is None else n_active
    chunk = chunk or pick_chunk(n, geom)
    c_max_dep, c_max_gat = budgets(n // chunk, geom)
    if cfg2 is not None and st.fine_b is None:
        raise ValueError("two-level persistent mode needs a state "
                         "with fine_b (re-init via init_sorted)")

    live0 = st.ids < n_active
    if cfg2 is not None:
        # order-invariant, hence hoisted OUT of the repair cond: inside
        # a shard_map its (auto-window) centroid psum must run on every
        # shard, while repairs fire per shard independently
        from . import pm2 as _pm2
        wmin = _pm2.window_min(st.pos, None, cfg2, st.masses, live=live0,
                               psum_axis=psum_axis)

    def _over(s):
        """Whether the order of ``s`` has drifted past the budgets."""
        live = s.ids < n_active
        k = cell_key(s.pos, live, cfg)
        if cfg2 is None:
            d1, g1 = _pair_totals(k, chunk, geom)
            return (d1 > c_max_dep) | (g1 > c_max_gat)
        d1, g1 = _pair_totals_seg(k, chunk, s.fine_b, geom)
        w, k2 = _fine_inputs(s.pos, live, wmin, cfg, cfg2)
        # fine keys of frozen-A slots are masked out of the fine spans;
        # a live A particle in the source set is a true entrant and
        # forces the repair
        seg_b = jnp.arange(n, dtype=jnp.int32) >= s.fine_b
        d2, g2 = _pair_totals(jnp.where(seg_b, k2, geom.sentinel), chunk,
                              geom)
        entrant = jnp.any(~seg_b & (w > 0.0))
        return ((d1 > c_max_dep) | (g1 > c_max_gat) | (d2 > c_max_dep)
                | (g2 > c_max_gat) | entrant)

    def _repair(s, seg: int = 0):
        key = cell_key(s.pos, live0, cfg)
        if cfg2 is None:
            return _sort_state(key, s.pos, s.vel, s.ids, s.masses,
                               s.resorts + 1, s.fine_b, s.col24, seg=seg)
        # segmented class key: A = live non-members by coarse id,
        # B = live window(+park) members of THIS moment by fine id,
        # dead last. Membership includes the parking band so the
        # source set cannot gain a frozen-A particle before the
        # next band crossing (which re-triggers this repair).
        from . import pm2 as _pm2w
        h2 = cfg2.window_size / cfg.grid
        coords2 = pm.cell_coords_dyn(s.pos, wmin, h2, cfg.grid)
        class_b = _pm2w._in_window(
            s.pos, wmin, cfg2.window_size,
            cfg2.margin - cfg2.park) & live0
        k2s = cell_key(s.pos, class_b, cfg, coords=coords2)
        skey = jnp.where(class_b, _seg_flag(geom) + k2s,
                         jnp.where(live0, key, _dead_key(geom)))
        fb = jnp.sum(skey < _seg_flag(geom)).astype(jnp.int32)
        return _sort_state(skey, s.pos, s.vel, s.ids, s.masses,
                           s.resorts + 1, fb, s.col24)

    need = _over(st)
    seg = pick_segment(n, chunk) if (cfg2 is None and two_tier) else 0
    if seg:
        # two-tier repair: tier 1 is a SEGMENT-LOCAL grouping sort,
        # sufficient for ordinary drift, where disorder is local. Tier 2
        # re-measures the locally repaired order and falls back to the
        # FULL sort only if it is still over budget (cross-segment
        # migration has accumulated).
        st, need_full = jax.lax.cond(
            need, lambda s: (lambda s1: (s1, _over(s1)))(
                _repair(s, seg=seg)),
            lambda s: (s, jnp.bool_(False)), st)
        st = jax.lax.cond(need_full, _repair, lambda s: s, st)
    else:
        st = jax.lax.cond(need, _repair, lambda s: s, st)

    live = st.ids < n_active
    acc = _transfer(st, live, cfg, base_kernels, psum_axis)
    if cfg2 is not None:
        from . import pm2 as _pm2
        acc = acc + _pm2.fine_accel(st.pos, live, cfg, cfg2,
                                    masses=st.masses, kernels=kernels,
                                    wmin=wmin, psum_axis=psum_axis)
    acc = _momentum_clean_live(acc, live.astype(jnp.float32), st.masses,
                               psum_axis=psum_axis)
    return st, g_const * acc


def init_sorted_multi(pos_flat: jax.Array, n_active, cfg: "P.PMConfig",
                      n_levels: int, vel_flat=None, masses=None,
                      col24=None) -> SortedPMState:
    """init_sorted for the MULTI-level persistent mode: ``fine_b`` is an
    i32[n_levels] class-boundary vector (all == N: every live particle
    starts class 0; the first accel_sorted_multi call migrates into the
    k+1-class order with one repair)."""
    st = init_sorted(pos_flat, n_active, cfg, vel_flat=vel_flat,
                     masses=masses, col24=col24)
    return st._replace(fine_b=jnp.full((n_levels,), pos_flat.shape[1],
                                       jnp.int32))


def accel_sorted_multi(st: SortedPMState, g_const, cfg: "P.PMConfig",
                       levels, *, n_active=None, chunk: int = 0,
                       psum_axis=None, kernels=None, base_kernels=None,
                       cfgx=None, pmx_shards: int = 1,
                       use_kernel: bool = False, interpret: bool = False
                       ) -> Tuple[SortedPMState, jax.Array]:
    """(state', acc) — MULTI-level PM acceleration on the persistent
    multi-segment order (pm2.pmn_accel_ref's telescoping physics on the
    k+1-class order, see the multi-segment section comment). ``levels``
    = tuple of PM2Config (outermost first, as pm2.pmn_accel_ref);
    ``kernels`` = pm2.levels_kernels(cfg, levels); ``st.fine_b`` must be
    i32[k] (init_sorted_multi). Repairs re-class by the INNERMOST
    park-shrunk window and sort class m by its level-m cell key.
    Multi-device (psum_axis): nested window origins are global
    (pm2._nested_wmins psums each level's centroid) and every grid joins
    the psum coupling.

    ``cfgx`` (a pmx.PMXConfig) terminates the stack with window-EXACT
    short-range forces — and on THIS order the compaction is free: the
    innermost class is a contiguous slot range, so the exact window's
    member buffer is one dynamic slice at fine_b[-1] (no flag sort, no
    scatter-back; ops/pmx.py compacts by a sort each frame). Members
    past the static capacity keep the mesh force (the same
    loud-truncation semantics as pmx.exact_accel); with ``cfgx`` the
    return gains a third element, i32[2] ``(n_members, n_corrected)``,
    so the engine can warn when the two differ. ``use_kernel`` runs its
    all-pairs passes on the Triton kernel (pmx.pair_accel).

    Multi-device pmx (``psum_axis`` + static ``pmx_shards`` = the dp mesh
    size): each shard slices capacity/n_shards slots of ITS innermost
    class, the slices are all_gather'd, and every shard runs the
    rectangular pair pass with its own members as receivers and the
    GLOBAL gathered buffer as sources — so cross-shard member pairs are
    seen by both ends with identical positions/masses, and the
    correction stays antisymmetric (momentum-exact). The counts are
    psum'd (global semantics everywhere)."""
    from . import pm2 as _pm2

    if cfg.auto_box:
        raise ValueError("persistent sorted mode needs a static box")
    if cfgx is not None:
        from . import pmx as _pmx
        if psum_axis is not None:
            if pmx_shards < 2:
                raise ValueError(
                    "multi-device pmx needs the static shard count "
                    "(pmx_shards = the dp mesh size) for the gathered "
                    "member buffer's per-shard slice")
            if cfgx.capacity % (512 * pmx_shards):
                raise ValueError(
                    f"pmx capacity {cfgx.capacity} must be a multiple "
                    f"of 512 * {pmx_shards} shards for the gathered "
                    "buffer's slice/tile alignment")
        _pmx._validate(cfg, levels, cfgx)
    levels = _pm2._validate_levels(cfg, levels)
    k_lv = len(levels)
    geom = _geom(cfg.grid)
    n = st.pos.shape[1]
    n_active = jnp.int32(n) if n_active is None else n_active
    chunk = chunk or pick_chunk(n, geom)
    c_max_dep, c_max_gat = budgets_multi(n // chunk, geom, k_lv + 1)
    if st.fine_b is None or st.fine_b.ndim != 1 or st.fine_b.shape[0] != k_lv:
        raise ValueError(
            f"multi-level persistent mode needs fine_b i32[{k_lv}] "
            "(init via init_sorted_multi)")

    live0 = st.ids < n_active
    slot = jnp.arange(n, dtype=jnp.int32)
    # nested window origins: order-invariant, hoisted OUT of the repair
    # cond (their centroid psums must run on every shard)
    wmins = _pm2._nested_wmins(st.pos, live0, cfg, levels, st.masses,
                               psum_axis=psum_axis)

    def _over(s):
        """Whether the order of ``s`` has drifted past the budgets."""
        live = s.ids < n_active
        d1, g1 = _pair_totals_multi(cell_key(s.pos, live, cfg), chunk,
                                    s.fine_b, geom)
        need = (d1 > c_max_dep) | (g1 > c_max_gat)
        for m in range(k_lv):
            w, k2 = _fine_inputs(s.pos, live, wmins[m], cfg, levels[m])
            # fine_b[m] = start slot of class m+1; level m+1's sources
            # live in classes >= m+1, i.e. slots >= fine_b[m] — keys of
            # frozen lower classes are masked out (first_class skips
            # their span passes); a live lower-class source is a true
            # entrant and forces the repair
            mask = slot >= s.fine_b[m]
            d2, g2 = _pair_totals_multi(
                jnp.where(mask, k2, geom.sentinel), chunk, s.fine_b, geom,
                first_class=m + 1)
            need = (need | (d2 > c_max_dep) | (g2 > c_max_gat)
                    | jnp.any(~mask & (w > 0.0)))
        return need

    def _repair(s):
        # class key: innermost park-shrunk window wins; class m sorts by
        # its level-m cell key offset by m * seg_flag; dead slots last
        flag = _seg_flag(geom)
        skey = jnp.where(live0, cell_key(s.pos, live0, cfg),
                         jnp.int32((k_lv + 1) * flag))
        for m, (c2, wm) in enumerate(zip(levels, wmins), start=1):
            h_m = c2.window_size / cfg.grid
            coords = pm.cell_coords_dyn(s.pos, wm, h_m, cfg.grid)
            memb = _pm2._in_window(s.pos, wm, c2.window_size,
                                   c2.margin - c2.park) & live0
            k_m = cell_key(s.pos, memb, cfg, coords=coords)
            skey = jnp.where(memb, m * flag + k_m, skey)
        bounds = jnp.stack([
            jnp.sum(skey < (m + 1) * flag).astype(jnp.int32)
            for m in range(k_lv)])
        return _sort_state(skey, s.pos, s.vel, s.ids, s.masses,
                           s.resorts + 1, bounds, s.col24)

    st = jax.lax.cond(_over(st), _repair, lambda s: s, st)

    live = st.ids < n_active
    acc = _transfer(st, live, cfg, base_kernels, psum_axis)
    eps_outer = cfg.softening
    for m, c2 in enumerate(levels):
        acc = acc + _pm2.fine_accel(
            st.pos, live, cfg, c2, masses=st.masses,
            kernels=None if kernels is None else kernels[m],
            wmin=wmins[m], psum_axis=psum_axis, eps_outer=eps_outer)
        eps_outer = float(c2.softening)

    if cfgx is not None:
        # window-exact correction on the contiguous innermost class: one
        # dynamic slice replaces ops/pmx.py's flag sort + scatter-back
        n_sh = pmx_shards if psum_axis is not None else 1
        B = min(cfgx.capacity, n * n_sh)     # global member budget
        B_s = B // n_sh                      # this shard's slice
        b = jnp.clip(st.fine_b[k_lv - 1], 0, jnp.int32(n - B_s))
        buf = jax.lax.dynamic_slice(st.pos, (jnp.int32(0), b), (3, B_s))
        ids_buf = jax.lax.dynamic_slice(st.ids, (b,), (B_s,))
        live_buf = ids_buf < n_active
        # exact window nested inside the innermost mesh window (the
        # same origin chain pmx_accel uses, order-invariant; its
        # centroid is GLOBAL under psum_axis, so every shard agrees)
        lv_live = (_pm2._in_window(st.pos, wmins[-1],
                                   levels[-1].window_size,
                                   levels[-1].margin) & live)
        wminx = _pm2.window_min(st.pos, None, cfgx, st.masses,
                                live=lv_live, psum_axis=psum_axis)
        wminx = jnp.clip(
            wminx, wmins[-1] + jnp.float32(levels[-1].margin),
            wmins[-1] + jnp.float32(levels[-1].window_size
                                    - levels[-1].margin
                                    - cfgx.window_size))
        w_buf = (_pm2._in_window(buf, wminx, cfgx.window_size,
                                 cfgx.margin) & live_buf
                 ).astype(jnp.float32)
        m_buf = w_buf
        if st.masses is not None:
            m_buf = m_buf * jax.lax.dynamic_slice(st.masses, (b,), (B_s,))
        if psum_axis is not None:
            # global member buffer: every shard sees every member with
            # identical positions/masses -> antisymmetric cross-shard
            # pairs. [n_sh, 3, B_s] -> [3, B]; zero-mass columns (w=0)
            # contribute nothing, so slice padding is harmless.
            src = jax.lax.all_gather(buf, psum_axis).transpose(
                1, 0, 2).reshape(3, B)
            m_src = jax.lax.all_gather(m_buf, psum_axis).reshape(B)
        else:
            src, m_src = buf, m_buf
        accel = _pmx.pair_accel(use_kernel, interpret)
        a_x = accel(buf, src, B, 1.0, cfgx.softening, masses=m_src)
        a_p = accel(buf, src, B, 1.0, eps_outer, masses=m_src)
        corr = (a_x - a_p) * w_buf[None]
        acc = jax.lax.dynamic_update_slice(
            acc, jax.lax.dynamic_slice(acc, (jnp.int32(0), b),
                                       (3, B_s)) + corr,
            (jnp.int32(0), b))
        # truncation accounting: members OUTSIDE the slice (innermost
        # class bigger than the capacity, or window members that
        # migrated out of the class between repairs) keep the mesh-only
        # force — count them so the engine can warn
        n_members = jnp.sum(
            _pm2._in_window(st.pos, wminx, cfgx.window_size, cfgx.margin)
            & live).astype(jnp.int32)
        n_corr = jnp.sum(w_buf).astype(jnp.int32)
        if psum_axis is not None:
            n_members = jax.lax.psum(n_members, psum_axis)
            n_corr = jax.lax.psum(n_corr, psum_axis)
        pmx_counts = jnp.stack([n_members, n_corr])

    acc = _momentum_clean_live(acc, live.astype(jnp.float32), st.masses,
                               psum_axis=psum_axis)
    if cfgx is not None:
        return st, g_const * acc, pmx_counts
    return st, g_const * acc


def step_sorted(st: SortedPMState, param_vec: jax.Array,
                pair_vec: jax.Array, n_active, cfg: "P.PMConfig", *,
                chunk: int = 0, psum_axis=None, cfg2=None, kernels=None,
                base_kernels=None, cfgx=None, pmx_shards: int = 1,
                two_tier: bool = True, use_kernel: bool = False,
                interpret: bool = False) -> SortedPMState:
    """One frame on the persistent state: PM self-gravity (repairing the
    order when needed; two-level with a single ``cfg2``, MULTI-level
    with a tuple of them — accel_sorted_multi, optionally terminated by
    the window-exact ``cfgx`` correction) + the reference
    kick/step contract (physics.kick_and_step_planes), all in slot
    order. ``two_tier=False`` forces full-sort-only repairs (see
    accel_sorted). With ``cfgx`` the return is ``(state', pmx_counts)``
    — see accel_sorted_multi."""
    pmx_counts = None
    if isinstance(cfg2, tuple):
        out = accel_sorted_multi(st, pair_vec[0], cfg, cfg2,
                                 n_active=n_active, chunk=chunk,
                                 psum_axis=psum_axis, kernels=kernels,
                                 base_kernels=base_kernels,
                                 cfgx=cfgx, pmx_shards=pmx_shards,
                                 use_kernel=use_kernel,
                                 interpret=interpret)
        if cfgx is not None:
            st, acc, pmx_counts = out
        else:
            st, acc = out
    else:
        if cfgx is not None:
            raise ValueError("cfgx (window-exact forces) rides the "
                             "multi-level class order — pass a TUPLE "
                             "cfg2 (pm_persist.accel_sorted_multi)")
        st, acc = accel_sorted(st, pair_vec[0], cfg, n_active=n_active,
                               chunk=chunk, psum_axis=psum_axis, cfg2=cfg2,
                               kernels=kernels, base_kernels=base_kernels,
                               two_tier=two_tier)
    shape = (3, st.pos.shape[1] // LANE, LANE)
    pos, vel = physics.kick_and_step_planes(
        st.pos.reshape(shape), st.vel.reshape(shape),
        acc.reshape(shape), param_vec)
    st = st._replace(pos=pos.reshape(3, -1), vel=vel.reshape(3, -1))
    if cfgx is not None:
        return st, pmx_counts
    return st


@functools.partial(jax.jit, static_argnames=(
    "cfg", "chunk", "cfg2", "cfgx", "two_tier", "use_kernel", "interpret"))
def step_sorted_jit(st, param_vec, pair_vec, n_active, cfg, chunk: int = 0,
                    cfg2=None, kernels=None, base_kernels=None, cfgx=None,
                    two_tier: bool = True, use_kernel: bool = False,
                    interpret: bool = False):
    return step_sorted(st, param_vec, pair_vec, n_active, cfg, chunk=chunk,
                       cfg2=cfg2, kernels=kernels, base_kernels=base_kernels,
                       cfgx=cfgx, two_tier=two_tier, use_kernel=use_kernel,
                       interpret=interpret)


def unsort(st: SortedPMState, arrays) -> tuple:
    """Return ``arrays`` (each (..., N) in slot order) re-ordered to
    identity order — the consumer-side bridge for colors / streaming /
    checkpoints. Paid only when identity order is actually needed (never
    inside the frame).

    ``ids`` is a permutation of 0..N-1, so one scatter by it per array
    IS the inverse permutation."""
    return tuple(jnp.zeros_like(a).at[..., st.ids].set(a) for a in arrays)
