"""Particle-mesh (PM) long-range gravity — CIC transfer + spectral solve.

The direct all-pairs sum (ops/pairwise*.py) is O(N^2), which caps it at
tens of thousands of particles per interactive frame. PM is the route to
millions of self-gravitating particles per frame: CIC mass deposit onto a
G^3 grid, FFT Poisson solve, CIC force gather — O(N + G^3 log G).

Physics matches the pairwise oracle's Plummer-softened monopole attraction
(ops/pairwise.py:8, itself the generalization of the reference's 1-body
attractor, /root/reference/src/shaders/compute.wgsl:56-66):

    a(x) = G_const * sum_j m_j K(x - x_j),
    K(r) = -r / (|r|^2 + eps^2)^(3/2)

Two boundary modes:
  * ``isolated`` (default): Hockney-Eastwood zero-padded doubling. K is
    sampled in real space on a (2G)^3 grid and convolved spectrally — the
    PM result is then exactly the CIC-smoothed direct sum (vacuum BCs, the
    mode that parity-tests against ops/pairwise.pairwise_accel).
  * ``periodic``: closed-form Plummer kernel in Fourier space
    (phi_hat = -4*pi*exp(-|k| eps)/k^2, accel via i*k), G^3 transforms —
    ~8x cheaper FFTs; forces include periodic images.

Gradient modes: ``exact`` (three inverse FFTs of the vector kernel) or
``fd`` (one inverse FFT of the potential + 4th-order central differences —
trades a little accuracy for ~2x fewer inverse transforms).

This module is the whole per-frame solver, any grid: XLA scatter-add
deposit, the FFT solve and the XLA gather. The persistent cell-ordered
state (ops/pm_persist.py) and the refinement levels (ops/pm2.py) call the
same deposit, solve and gather.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import params as P
from . import physics


def cell_coords_dyn(pos_flat: jax.Array, box_min, cell_size,
                    grid: int, periodic: bool = False) -> jax.Array:
    """f32[3, N] continuous cell-space coords for a (possibly traced) box.

    Isolated mode clamps so the CIC upper corner (floor+1) stays on the
    grid: coords in [0, G-1-ulp]. Periodic mode WRAPS positions into the
    box (coords in [0, G), out-of-box particles re-enter on the far side)
    and the deposit/gather wrap the final cell's upper corner to cell 0.
    ``box_min``: f32[3, 1] or tuple;
    ``cell_size``: scalar (python float or traced)."""
    box_min = jnp.asarray(box_min, jnp.float32).reshape(3, 1)
    c = (pos_flat - box_min) / cell_size
    if periodic:
        # mod can return exactly G for inputs just below a box multiple
        # (f32 rounding); nudge back inside
        return jnp.minimum(jnp.mod(c, np.float32(grid)),
                           np.float32(grid) - 1e-3)
    return jnp.clip(c, 0.0, np.float32(grid - 1) - 1e-3)


def cell_coords(pos_flat: jax.Array, cfg: "P.PMConfig") -> jax.Array:
    """cell_coords_dyn with the config's static box."""
    return cell_coords_dyn(pos_flat, cfg.box_min, cfg.cell_size, cfg.grid,
                           periodic=cfg.boundary == "periodic")


def auto_box(pos_flat: jax.Array, n_active: jax.Array, grid: int,
             pad: float = 0.05):
    """(box_min f32[3,1], cell_size scalar) — a traced cubic box tracking
    the live particle cloud (auto-zoom PM): the grid's resolution follows
    the cloud instead of a fixed world box. Padding particles are excluded
    from the extent."""
    n = pos_flat.shape[1]
    live = jnp.arange(n, dtype=jnp.int32) < n_active
    big = jnp.float32(3.0e38)
    lo = jnp.min(jnp.where(live[None], pos_flat, big), axis=1)
    hi = jnp.max(jnp.where(live[None], pos_flat, -big), axis=1)
    extent = jnp.max(hi - lo)
    size = jnp.maximum(extent * (1.0 + 2.0 * pad), 1e-3)
    center = 0.5 * (lo + hi)
    box_min = (center - 0.5 * size).reshape(3, 1)
    return box_min, size / grid


def cic_weights(c: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(i0 i32[3,N] lower corner, f f32[3,N] fractional offset)."""
    i0 = jnp.floor(c).astype(jnp.int32)
    return i0, c - i0.astype(jnp.float32)


_CORNERS = [(cz, cy, cx) for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)]


def cic_deposit(c: jax.Array, m: jax.Array, grid: int,
                wrap: bool = False) -> jax.Array:
    """f32[G, G, G] mass grid from cell coords c f32[3, N] and per-particle
    weights m f32[N] — XLA scatter-add (atomic adds on a GPU). The one
    deposit of every PM path: the per-frame solvers feed identity-order
    coords, the persistent order (ops/pm_persist.py) its slot-order ones.
    ``wrap`` (periodic boundary) wraps the last cell's upper corner to
    cell 0."""
    i0, f = cic_weights(c)
    rho = jnp.zeros((grid, grid, grid), jnp.float32)
    for cz, cy, cx in _CORNERS:
        w = (m
             * jnp.where(cx, f[0], 1.0 - f[0])
             * jnp.where(cy, f[1], 1.0 - f[1])
             * jnp.where(cz, f[2], 1.0 - f[2]))
        iz, iy, ix = i0[2] + cz, i0[1] + cy, i0[0] + cx
        if wrap:
            iz, iy, ix = iz % grid, iy % grid, ix % grid
        rho = rho.at[iz, iy, ix].add(w)
    return rho


def cic_gather(grids: jax.Array, c: jax.Array, grid: int,
               wrap: bool = False) -> jax.Array:
    """f32[3, N] trilinear interpolation of grids f32[3, G, G, G] at cell
    coords c f32[3, N] — the transpose of cic_deposit (same weights, so
    deposit and gather stay symmetric and momentum is conserved)."""
    i0, f = cic_weights(c)
    out = jnp.zeros(c.shape, jnp.float32)
    for cz, cy, cx in _CORNERS:
        w = (jnp.where(cx, f[0], 1.0 - f[0])
             * jnp.where(cy, f[1], 1.0 - f[1])
             * jnp.where(cz, f[2], 1.0 - f[2]))
        iz, iy, ix = i0[2] + cz, i0[1] + cy, i0[0] + cx
        if wrap:
            iz, iy, ix = iz % grid, iy % grid, ix % grid
        out = out + w[None] * grids[:, iz, iy, ix]
    return out


def cic_deposit_ref(pos_flat: jax.Array, n_active: jax.Array,
                    cfg: "P.PMConfig", coords=None,
                    masses=None) -> jax.Array:
    """f32[G, G, G] mass grid of the identity-order particles (the first
    ``n_active`` are live).

    ``coords`` overrides the cell coords (auto-box path); ``masses``
    f32[N] overrides the unit masses."""
    n = pos_flat.shape[1]
    c = cell_coords(pos_flat, cfg) if coords is None else coords
    m = (jnp.arange(n, dtype=jnp.int32) < n_active).astype(jnp.float32)
    if masses is not None:
        m = m * masses
    return cic_deposit(c, m, cfg.grid, cfg.boundary == "periodic")


def cic_gather_ref(grids: jax.Array, pos_flat: jax.Array,
                   cfg: "P.PMConfig", coords=None) -> jax.Array:
    """f32[3, N] trilinear interpolation of grids f32[3, G, G, G]."""
    c = cell_coords(pos_flat, cfg) if coords is None else coords
    return cic_gather(grids, c, cfg.grid, cfg.boundary == "periodic")


# ---------------------------------------------------------------------------
# spectral solve
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _isolated_kernels_host(grid: int, h: float, eps: float,
                           gradient: str) -> tuple:
    """rfftn of the real-space kernel on the doubled grid (host, cached).

    Hockney-Eastwood: sample K (or the potential phi for gradient='fd') at
    circularly-wrapped offsets on a (2G)^3 grid; circular convolution with
    the zero-padded mass grid is then the exact linear convolution for
    sources and targets inside the G^3 physical region.
    """
    g2 = 2 * grid
    idx = np.arange(g2)
    d = np.where(idx < grid, idx, idx - g2).astype(np.float32) * h
    dz = d[:, None, None]
    dy = d[None, :, None]
    dx = d[None, None, :]
    r2 = dx * dx + dy * dy + dz * dz + np.float32(eps * eps)
    inv_r3 = r2 ** np.float32(-1.5)
    if gradient == "fd":
        phi = -(r2 ** np.float32(-0.5))
        return (np.fft.rfftn(phi).astype(np.complex64),)
    return tuple(
        np.fft.rfftn(-dc * inv_r3).astype(np.complex64)
        for dc in (dx, dy, dz)
    )


@functools.lru_cache(maxsize=8)
def _isolated_diff_kernels_host(grid: int, h: float, eps: float,
                                eps_outer: float, gradient: str) -> tuple:
    """rfftn of the DIFFERENCE kernel g_eps - g_eps_outer (eps < eps_outer)
    on the doubled grid — the short-range part a coarse mesh softened at
    eps_outer cannot resolve. Decays like r^-4 beyond eps_outer, so its
    support is local to the refinement window (ops/pm2.py)."""
    g2 = 2 * grid
    idx = np.arange(g2)
    d = np.where(idx < grid, idx, idx - g2).astype(np.float32) * h
    dz = d[:, None, None]
    dy = d[None, :, None]
    dx = d[None, None, :]
    r2 = dx * dx + dy * dy + dz * dz
    r2a = r2 + np.float32(eps * eps)
    r2b = r2 + np.float32(eps_outer * eps_outer)
    if gradient == "fd":
        phi = -(r2a ** np.float32(-0.5) - r2b ** np.float32(-0.5))
        return (np.fft.rfftn(phi).astype(np.complex64),)
    k = r2a ** np.float32(-1.5) - r2b ** np.float32(-1.5)
    return tuple(
        np.fft.rfftn(-dc * k).astype(np.complex64)
        for dc in (dx, dy, dz)
    )


def diff_kernels_device(grid: int, h, eps, eps_outer,
                        gradient: str = "exact") -> tuple:
    """Difference kernels as DEVICE-resident (real, imag) f32 pairs,
    cached. Passed into jits as runtime ARGUMENTS instead of closed-over
    numpy constants, which XLA would embed in the program (and compile)
    on every new configuration; they ship as two f32 planes and recombine
    on-device."""
    key = (grid, float(h), float(eps), float(eps_outer), gradient)
    got = _DIFF_DEV_CACHE.get(key)
    if got is None:
        ks = _isolated_diff_kernels_host(*key)
        got = tuple((jnp.asarray(k.real.astype(np.float32)),
                     jnp.asarray(k.imag.astype(np.float32))) for k in ks)
        _DIFF_DEV_CACHE[key] = got
    return got


_DIFF_DEV_CACHE: dict = {}


def base_kernels_device(cfg: "P.PMConfig", softening,
                        cell_size=None) -> tuple:
    """BASE solve kernels as device-resident (real, imag) f32 pairs,
    cached — the diff_kernels_device treatment for the coarse Hockney /
    periodic kernels. Closed-over kernel constants are serialized into
    the program body whether they are numpy OR device arrays (measured:
    identical HLO bytes either way), and at G=256 the three doubled-grid
    rfftn kernels are ~1.6 GB of complex64 — far too large a program to
    compile. Pass these into jits as the ``kernels`` argument of
    solve_accel / solve_accel_pair instead."""
    g = cfg.grid
    h = cfg.cell_size if cell_size is None else cell_size
    eps = float(softening)
    key = (cfg.boundary, g, float(h), eps, cfg.gradient)
    got = _BASE_DEV_CACHE.get(key)
    if got is None:
        ks = (_isolated_kernels_host(g, h, eps, cfg.gradient)
              if cfg.boundary == "isolated"
              else _periodic_kernels_host(g, h, eps, cfg.gradient))
        got = tuple((jnp.asarray(k.real.astype(np.float32)),
                     jnp.asarray(k.imag.astype(np.float32))) for k in ks)
        _BASE_DEV_CACHE[key] = got
    return got


_BASE_DEV_CACHE: dict = {}


def solve_accel_diff(rho: jax.Array, grid: int, h, eps, eps_outer,
                     gradient: str = "exact", kernels=None) -> jax.Array:
    """f32[3, G, G, G] acceleration grids for the short-range difference
    kernel (isolated Hockney; the fine level of the two-level PM).
    ``h``/``eps``/``eps_outer`` must be static python floats (cached
    kernel FFTs). ``kernels``: optional diff_kernels_device() output
    threaded through the caller's jit as arguments (keeps the program
    small); default embeds host-side constants (fine at small grids)."""
    rho_p = jnp.pad(rho, ((0, grid), (0, grid), (0, grid)))
    rho_hat = jnp.fft.rfftn(rho_p)
    if kernels is None:
        ks = [jnp.asarray(k) for k in _isolated_diff_kernels_host(
            grid, float(h), float(eps), float(eps_outer), gradient)]
    else:
        ks = [r + 1j * i for r, i in kernels]
    if gradient == "fd":
        phi = _irfftn_octant(rho_hat * ks[0], grid)
        return _fd_gradient(phi.astype(jnp.float32), float(h))
    specs = rho_hat[None] * jnp.stack(ks)
    return _irfftn_octant_batch(specs, grid).astype(jnp.float32)


@functools.lru_cache(maxsize=8)
def _periodic_kernels_host(grid: int, h: float, eps: float,
                           gradient: str) -> tuple:
    """Closed-form Plummer kernel in Fourier space on the G^3 grid."""
    k1 = 2.0 * np.pi * np.fft.fftfreq(grid, d=h).astype(np.float32)
    kr = 2.0 * np.pi * np.fft.rfftfreq(grid, d=h).astype(np.float32)
    kz = k1[:, None, None]
    ky = k1[None, :, None]
    kx = kr[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    kmag = np.sqrt(k2)
    with np.errstate(divide="ignore", invalid="ignore"):
        phi_hat = np.where(k2 > 0.0, -4.0 * np.pi * np.exp(-kmag * eps) / k2,
                           0.0).astype(np.complex64)
    if gradient == "fd":
        return (phi_hat,)
    return tuple((-1j * kc * phi_hat).astype(np.complex64)
                 for kc in (kx, ky, kz))


def _irfftn_octant(spec: jax.Array, g: int) -> jax.Array:
    """Inverse 3D rfft of a (2g, 2g, g+1) half-spectrum, keeping only the
    physical first-octant (g, g, g) output.

    The inverse is separable, so each axis can be sliced to its needed
    half as soon as it returns to the spatial domain — the remaining axes
    then transform half/quarter as much data (~40% cheaper than a full
    ``irfftn`` + slice; the Hockney solve only ever reads the octant).
    """
    x = jnp.fft.ifft(spec, axis=0)[:g]                    # z spatial
    x = jnp.fft.ifft(x, axis=1)[:, :g]                    # y spatial
    return jnp.fft.irfft(x, n=2 * g, axis=2)[:, :, :g]    # x spatial (c2r)


def _irfftn_octant_batch(specs: jax.Array, g: int) -> jax.Array:
    """_irfftn_octant over a leading batch axis in ONE set of transforms
    (the three gradient components batch into each axis pass instead of
    launching nine separate FFTs)."""
    x = jnp.fft.ifft(specs, axis=1)[:, :g]
    x = jnp.fft.ifft(x, axis=2)[:, :, :g]
    return jnp.fft.irfft(x, n=2 * g, axis=3)[..., :g]


def _fd_gradient(phi: jax.Array, h: float) -> jax.Array:
    """-grad(phi) via 4th-order central differences; f32[3, G, G, G].

    Differences wrap circularly: exact for periodic mode; for isolated
    mode the wrap touches only the outermost two grid layers (the box
    carries a margin around the cloud, so clamped particles there are
    edge cases the 'exact' gradient mode handles properly).
    """
    def diff(axis):
        p1 = jnp.roll(phi, 1, axis=axis)
        m1 = jnp.roll(phi, -1, axis=axis)
        p2 = jnp.roll(phi, 2, axis=axis)
        m2 = jnp.roll(phi, -2, axis=axis)
        return (8.0 * (p1 - m1) - (p2 - m2)) / (12.0 * h)
    return jnp.stack([diff(2), diff(1), diff(0)])


def solve_accel_pair(rho: jax.Array, rho2: jax.Array, cfg: "P.PMConfig",
                     softening, kernels2, kernels1=None) -> tuple:
    """(grids, grids2) f32[3, G, G, G] each — the ISOLATED exact-gradient
    coarse solve and the fine difference-kernel solve (two-level PM)
    batched through ONE transform set: both levels share the Hockney
    doubled-grid shape, so their forward rfftns batch to 2 and the six
    gradient-component inverses ride one _irfftn_octant_batch instead of
    two threes. ``kernels2`` = pm2.fine_kernels(...) device pairs;
    ``kernels1`` = base_kernels_device(...) pairs (runtime args — else
    the coarse kernels bake into the program body, see solve_accel).
    Caller gates on boundary == 'isolated' and both gradients 'exact'."""
    g = cfg.grid
    if kernels1 is not None:
        ks1 = [r + 1j * i for r, i in kernels1]
    else:
        ks1 = [jnp.asarray(k) for k in _isolated_kernels_host(
            g, cfg.cell_size, float(softening), "exact")]
    pad = ((0, 0), (0, g), (0, g), (0, g))
    rp = jnp.pad(jnp.stack([rho, rho2]), pad)
    rhat = jnp.fft.rfftn(rp, axes=(1, 2, 3))
    ks2 = [r + 1j * i for r, i in kernels2]
    specs = jnp.concatenate([
        rhat[0][None] * jnp.stack(ks1),
        rhat[1][None] * jnp.stack(ks2)])
    out = _irfftn_octant_batch(specs, g).astype(jnp.float32)
    return out[:3], out[3:]


def solve_accel(rho: jax.Array, cfg: "P.PMConfig",
                softening, cell_size=None, kernels=None) -> jax.Array:
    """f32[3, G, G, G] acceleration grids (unit G_const) from the mass grid.

    ``softening`` must be a static python float (the kernel FFT is cached
    per (grid, h, eps, mode)). ``cell_size`` overrides the config's static
    h (the auto-box path solves in cell units, h=1). ``kernels``
    (base_kernels_device pairs) routes the kernel spectra in as runtime
    arguments instead of baked-in program constants — REQUIRED under jit
    at G=256, where the constants alone are ~1.6 GB of serialized
    program body (base_kernels_device docstring).
    """
    g = cfg.grid
    h = cfg.cell_size if cell_size is None else cell_size
    eps = float(softening)
    if kernels is not None:
        ks = [r + 1j * i for r, i in kernels]
    if cfg.boundary == "isolated":
        if kernels is None:
            ks = [jnp.asarray(k) for k in
                  _isolated_kernels_host(g, h, eps, cfg.gradient)]
        rho_p = jnp.pad(rho, ((0, g), (0, g), (0, g)))
        rho_hat = jnp.fft.rfftn(rho_p)
        if cfg.gradient == "fd":
            phi = _irfftn_octant(rho_hat * ks[0], g)
            return _fd_gradient(phi.astype(jnp.float32), h)
        specs = rho_hat[None] * jnp.stack(ks)
        return _irfftn_octant_batch(specs, g).astype(jnp.float32)
    elif cfg.boundary == "periodic":
        if kernels is None:
            ks = [jnp.asarray(k) for k in
                  _periodic_kernels_host(g, h, eps, cfg.gradient)]
        rho_hat = jnp.fft.rfftn(rho)
        if cfg.gradient == "fd":
            phi = jnp.fft.irfftn(rho_hat * ks[0], s=rho.shape)
            return _fd_gradient(phi.astype(jnp.float32), h)
        specs = rho_hat[None] * jnp.stack(ks)
        return jnp.fft.irfftn(specs, s=rho.shape,
                              axes=(1, 2, 3)).astype(jnp.float32)
    raise ValueError(f"unknown boundary mode {cfg.boundary!r}")


# ---------------------------------------------------------------------------
# full reference pipeline
# ---------------------------------------------------------------------------

def momentum_clean(acc: jax.Array, n_active: jax.Array,
                   masses=None) -> jax.Array:
    """Subtract the live mass-weighted mean acceleration (zero padding).

    The exact PM self-force sums (mass-weighted) to zero by the
    antisymmetry of the kernel; what survives numerically is solver bias
    — FFT rounding and deposit/gather summation order — which would
    otherwise pump momentum into the cloud every step. Removing the
    weighted mean restores conservation exactly: net momentum change = sum_i
    m_i (a_i - mean) = 0 when mean = sum m_i a_i / sum m_i."""
    n = acc.shape[1]
    live = (jnp.arange(n, dtype=jnp.int32) < n_active).astype(jnp.float32)
    w = live if masses is None else live * masses
    count = jnp.maximum(w.sum(), 1e-12)
    mean = (acc * w[None]).sum(axis=1, keepdims=True) / count
    return (acc - mean) * live[None]


def pm_accel_ref(pos_flat: jax.Array, n_active: jax.Array, g_const,
                 softening, cfg: "P.PMConfig", masses=None,
                 kernels=None) -> jax.Array:
    """f32[3, N] PM acceleration — scatter/gather solver (any grid).

    With ``cfg.auto_box`` the box is a traced cube tracking the cloud and
    the solve runs in CELL units (h=1, eps = softening in cells; cached
    kernel FFTs are box-independent); physical acceleration is the
    cell-unit result scaled by 1/h^2 (a ~ h*dc / (h^2 |dc|^2)^1.5).
    ``kernels`` (base_kernels_device pairs, static box only) routes the
    solve's kernel spectra in as runtime arguments (solve_accel).
    """
    if cfg.auto_box:
        box_min, cell = auto_box(pos_flat, n_active, cfg.grid)
        c = cell_coords_dyn(pos_flat, box_min, cell, cfg.grid)
        rho = cic_deposit_ref(pos_flat, n_active, cfg, coords=c,
                              masses=masses)
        grids = solve_accel(rho, cfg, softening, cell_size=1.0)
        acc = cic_gather_ref(grids, pos_flat, cfg, coords=c)
        acc = momentum_clean(acc, n_active, masses)
        return (g_const / (cell * cell)) * acc
    rho = cic_deposit_ref(pos_flat, n_active, cfg, masses=masses)
    grids = solve_accel(rho, cfg, softening, kernels=kernels)
    acc = momentum_clean(cic_gather_ref(grids, pos_flat, cfg), n_active,
                         masses)
    return g_const * acc


def step_pm_ref(pos: jax.Array, vel: jax.Array, param_vec: jax.Array,
                pair_vec: jax.Array, n_active: jax.Array,
                cfg: "P.PMConfig", masses=None,
                kernels=None) -> Tuple[jax.Array, jax.Array]:
    """One frame: PM self-gravity + the reference's attractor step, on
    (3, R, LANE) planes. Same integrator contract as step_pairwise
    (ops/pairwise.py:49): accelerations accumulate into velocity first,
    then p += v*dt, then v *= damping (compute.wgsl:52-72).

    The softening rides in ``cfg`` (static, baked into the cached kernel
    FFT); pair_vec[0] (G_const) stays traced. ``kernels`` as in
    pm_accel_ref.
    """
    flat = pos.reshape(3, -1)
    acc = pm_accel_ref(flat, n_active, pair_vec[0], cfg.softening, cfg,
                       masses=masses, kernels=kernels)
    return physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                        param_vec)


@functools.partial(jax.jit, static_argnames=("cfg",))
def step_pm_jit(pos, vel, param_vec, pair_vec, n_active, cfg, masses=None,
                kernels=None):
    return step_pm_ref(pos, vel, param_vec, pair_vec, n_active, cfg,
                       masses=masses, kernels=kernels)
