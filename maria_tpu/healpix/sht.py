"""Spherical harmonic transforms on HEALPix grids, scalar and spin-2.

Replaces healpy's synalm/alm2map/map2alm (reference:
maria/cmb/generation.py:36-58, maria/map/healpix.py:126) with a
device design: the associated-Legendre / Wigner-d recursion runs as
one `lax.scan` over ell on device, vectorized over all m and all rings
at once, with libsharp-style dynamic rescaling so float32 never
underflows in the evanescent region. Per-ring FFT assembly (irregular
ring lengths) stays on the host.

Algorithm notes
---------------
All theta-dependence comes from Wigner-d matrix elements:
``sY_lm(theta, phi) = (-1)^m sqrt((2l+1)/4pi) d^l_{-m,s}(theta) e^{im phi}``
(scalar lambda_lm is the s=0 case). The three-term recursion in l,

  l*sqrt(((l+1)^2-m^2)((l+1)^2-s^2)) d_{l+1}
    = (2l+1)(l(l+1) cos(theta) + m s) d_l
      - (l+1)*sqrt((l^2-m^2)(l^2-s^2)) d_{l-1},

its seeds (closed form at l = max(|m|, |s|)), and the north/south parity
``d^l_{-m,s}(pi - theta) = (-1)^{l+m} d^l_{-m,-s}(theta)`` were each
verified against sympy's Rotation.d (tests/test_sht_spin.py). Only the
northern rings are computed; southern rings come from parity (for spin
fields this swaps s <-> -s, so both s=+2 and s=-2 recursions run in the
same scan).

Rescaling: raw d values are bounded by 1 but seeds scale like
sin(theta)^(m +- s), which underflows float32 near the poles for
m >~ 90. Each (m, ring) lane carries a shared power-of-2^60 exponent k;
values only contribute to the accumulators once k == 0 (k > 0 means the
true value is < 2^-30 * 2^-60 — negligible). This keeps the whole scan
in f32 on the VPU.

Polarization conventions follow healpy/HEALPix (COSMO):
``Q + iU = -sum_lm (aE + i aB)_lm 2Y_lm``.
"""

from __future__ import annotations

import logging
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import scipy.special as sps

from .core import nside2npix, ring_info

logger = logging.getLogger("maria_tpu")

__all__ = [
    "synalm",
    "synalm_cmb",
    "alm2map",
    "map2alm",
    "alm2map_spin",
    "map2alm_spin",
    "alm_index",
]

_BIG = 2.0**30
_DOWN = 2.0**-60
_UP = 2.0**60

# f64 seeds underflow (even with one 2^60 rescale headroom this is where
# the *host-side* log-space seed math stays exact); beyond this the
# single-exponent-per-lane scheme would need wider k steps.
_LMAX_SAFE = 100000


def alm_index(lmax: int):
    return np.tril_indices(lmax + 1)


# --------------------------------------------------------------------------
# random alm draws (host, float64 — cheap, and exactness matters here)
# --------------------------------------------------------------------------
def _unit_alm(lmax: int, rng) -> np.ndarray:
    """a_lm with unit variance per (l, m): m=0 real N(0,1), m>0 complex
    with unit total variance."""
    L = lmax + 1
    alm = np.zeros((L, L), dtype=complex)
    alm[:, 0] = rng.standard_normal(L)
    re = rng.standard_normal((L, L))
    im = rng.standard_normal((L, L))
    mask = np.tril(np.ones((L, L), dtype=bool), -1)  # m < l? no: m <= l, m >= 1
    # columns m >= 1, rows l >= m
    rows, cols = np.tril_indices(L)
    sel = cols >= 1
    alm[rows[sel], cols[sel]] = (re[rows[sel], cols[sel]] + 1j * im[rows[sel], cols[sel]]) / np.sqrt(2)
    del mask
    return alm


def synalm(cl: np.ndarray, lmax: int = None, seed: int = None) -> np.ndarray:
    """Draw a_lm ~ N(0, C_l). Returns complex array indexed [l, m]."""
    rng = np.random.default_rng(seed)
    cl = np.asarray(cl, dtype=float)
    lmax = lmax if lmax is not None else len(cl) - 1
    cl = np.pad(cl[: lmax + 1], (0, max(0, lmax + 1 - len(cl))))
    return _unit_alm(lmax, rng) * np.sqrt(np.clip(cl, 0, None))[:, None]


def synalm_cmb(spectra: dict, lmax: int, seed: int = None):
    """Correlated (aT, aE, aB) from TT/EE/BB/TE spectra (the reference
    uses healpy.synalm with new=True, cmb/generation.py:47-52).

    Per l, (aT, aE) are jointly Gaussian with covariance
    [[TT, TE], [TE, EE]] (Cholesky), aB independent with BB.
    """
    rng = np.random.default_rng(seed)

    def _cl(name):
        c = np.asarray(spectra.get(name, np.zeros(lmax + 1)), dtype=float)
        c = np.pad(c[: lmax + 1], (0, max(0, lmax + 1 - len(c))))
        return c

    TT, EE, BB, TE = _cl("TT"), _cl("EE"), _cl("BB"), _cl("TE")
    xi1 = _unit_alm(lmax, rng)
    xi2 = _unit_alm(lmax, rng)
    xi3 = _unit_alm(lmax, rng)
    cT = np.sqrt(np.clip(TT, 0, None))
    with np.errstate(divide="ignore", invalid="ignore"):
        cTE = np.where(cT > 0, TE / np.where(cT > 0, cT, 1.0), 0.0)
    cE = np.sqrt(np.clip(EE - cTE**2, 0, None))
    aT = xi1 * cT[:, None]
    aE = xi1 * cTE[:, None] + xi2 * cE[:, None]
    aB = xi3 * np.sqrt(np.clip(BB, 0, None))[:, None]
    return aT, aE, aB


# --------------------------------------------------------------------------
# host-side geometry + recursion tables
# --------------------------------------------------------------------------
@lru_cache(maxsize=32)
def _ring_geometry(nside: int):
    rings = ring_info(nside)
    n_rings = len(rings["z"])
    nh = 2 * nside  # northern rings incl. the equator (index nh-1)
    z_n = rings["z"][:nh].copy()
    return rings, nh, z_n


@lru_cache(maxsize=32)
def _recursion_tables(lmax: int, spin: int):
    """alpha/beta/gamma[l, m] (f32) for the raw Wigner-d l-recursion
    d_l = (alpha*x + beta) d_{l-1} - gamma d_{l-2}, zeroed outside the
    valid region l > max(m, |spin|)."""
    L = lmax + 1
    ell = np.arange(L, dtype=float)[:, None]
    m = np.arange(L, dtype=float)[None, :]
    s = float(spin)
    lmin = np.maximum(m, abs(s))
    with np.errstate(invalid="ignore", divide="ignore"):
        D = (ell - 1) * np.sqrt((ell**2 - m**2) * (ell**2 - s**2))
        alpha = (2 * ell - 1) * ell * (ell - 1) / D
        beta = (2 * ell - 1) * m * s / D
        gamma = ell * np.sqrt(((ell - 1) ** 2 - m**2) * ((ell - 1) ** 2 - s**2)) / D
    valid = ell > lmin
    alpha = np.where(valid, alpha, 0.0)
    beta = np.where(valid, beta, 0.0)
    gamma = np.where(valid & (ell - 1 > lmin), gamma, 0.0)
    if spin == 0:
        # the l=1, m=0 step divides by (l-1)=0; d^1_{00} = x * d^0_{00}
        alpha[1, 0], beta[1, 0], gamma[1, 0] = 1.0, 0.0, 0.0
    return (
        alpha.astype(np.float32),
        beta.astype(np.float32),
        gamma.astype(np.float32),
    )


def _seed_from_log(log_mag: np.ndarray, sign: np.ndarray):
    """Split log2 magnitude into (value in ~[2^-30, 2^30), exponent k of
    2^-60) for the rescaled recursion lanes."""
    e2 = log_mag / np.log(2.0)
    k = np.maximum(0, np.ceil((-30.0 - e2) / 60.0)).astype(np.int32)
    val = sign * np.exp2(e2 + 60.0 * k)
    return val.astype(np.float32), k


@lru_cache(maxsize=32)
def _seed_tables(lmax: int, nside: int, spin: int):
    """Seed (value, exponent) arrays, shape (L, nh), for d^{lmin}_{-m, s}
    at each northern ring; plus the per-m seed step lmin(m)."""
    _, nh, z_n = _ring_geometry(nside)
    L = lmax + 1
    s = int(spin)
    m = np.arange(L, dtype=float)[:, None]
    # half angles: sin(b/2) = sqrt((1-z)/2), cos(b/2) = sqrt((1+z)/2)
    lsh = 0.5 * np.log((1.0 - z_n) / 2.0)[None, :]  # log sin(b/2)
    lch = 0.5 * np.log((1.0 + z_n) / 2.0)[None, :]  # log cos(b/2)

    # general seed at l = m (valid for m >= |s|):
    # d^m_{-m,s} = sqrt((2m)!/((m-s)!(m+s)!)) cos(b/2)^(m-s) sin(b/2)^(m+s)
    with np.errstate(invalid="ignore"):
        log_mag = (
            0.5 * (sps.gammaln(2 * m + 1) - sps.gammaln(m - s + 1) - sps.gammaln(m + s + 1))
            + (m - s) * lch
            + (m + s) * lsh
        )
    sign = np.ones_like(log_mag)

    if s != 0:
        # m < |s|: seed at l = |s|; closed forms for |s| = 2
        assert abs(s) == 2, "only spins 0 and ±2 are implemented"
        z = z_n[None, :]
        sinb = np.sqrt(np.clip(1 - z_n**2, 0, None))[None, :]
        d2_0 = np.sqrt(6.0) / 4.0 * sinb**2  # d^2_{0, ±2}
        d2_1 = (1 - z) / 2 * sinb if s > 0 else -(1 + z) / 2 * sinb  # d^2_{-1, s}
        for mm, val in ((0, d2_0), (1, d2_1)):
            mag = np.abs(val[0])
            with np.errstate(divide="ignore"):
                log_mag[mm] = np.where(mag > 0, np.log(np.maximum(mag, 1e-300)), -1e9)
            sign[mm] = np.sign(val[0]) + (val[0] == 0)

    seed_val, seed_exp = _seed_from_log(log_mag, sign)
    seed_step = np.maximum(np.arange(L), abs(s)).astype(np.int32)
    return seed_val, seed_exp, seed_step


def _norm_l(lmax: int):
    ell = np.arange(lmax + 1, dtype=float)
    return np.sqrt((2 * ell + 1) / (4 * np.pi))


# --------------------------------------------------------------------------
# device scan cores
# --------------------------------------------------------------------------
def _rescale(lam, lam_prev, k):
    """Shared-exponent rescale of a recursion lane pair. Never rescale up
    at k == 0: small values there are genuine (zero crossings)."""
    a = jnp.abs(lam)
    big = a > _BIG
    small = (a < 1.0 / _BIG) & (k > 0)
    scale = jnp.where(big, _DOWN, jnp.where(small, _UP, 1.0)).astype(lam.dtype)
    dk = jnp.where(big, -1, jnp.where(small, 1, 0))
    return lam * scale, lam_prev * scale, k + dk


def _lane_step(carry, alpha_r, beta_r, gamma_r, seed_mask, z, seed_val, seed_exp):
    """One l-step of a rescaled Wigner-d recursion lane; returns the new
    carry and this step's contribution (exact values, zeros where the
    lane's exponent is still below representable range)."""
    lam, lam_prev, k = carry
    rec = (alpha_r[:, None] * z[None, :] + beta_r[:, None]) * lam - gamma_r[:, None] * lam_prev
    sm = seed_mask[:, None]
    lam_prev2 = jnp.where(sm, 0.0, lam)
    lam2 = jnp.where(sm, seed_val, rec)
    k2 = jnp.where(sm, seed_exp, k)
    lam2, lam_prev2, k2 = _rescale(lam2, lam_prev2, k2)
    contrib = jnp.where(k2 == 0, lam2, 0.0)
    return (lam2, lam_prev2, k2), contrib


def _zero_lane(L, nh):
    return (
        jnp.zeros((L, nh), jnp.float32),
        jnp.zeros((L, nh), jnp.float32),
        jnp.zeros((L, nh), jnp.int32),
    )



# --------------------------------------------------------------------------
# belt / polar geometry
#
# The equatorial belt (rings with 4*nside pixels, ~75% of the sky) has no
# m-aliasing for lmax < 4*nside, so its Fourier assembly is a dense
# batched FFT that runs ON DEVICE, fused into the same jit as the scan.
# Only the short polar rings (irregular lengths, m-aliasing) go through
# the host, and only their (L, nside-1) g-columns cross the transfer
# boundary — not the maps.
# --------------------------------------------------------------------------
@lru_cache(maxsize=32)
def _belt_tables(nside: int, lmax: int):
    rings, nh, _ = _ring_geometry(nside)
    n_rings = len(rings["z"])
    N = 4 * nside
    b0 = nside - 1  # first belt ring (0-based); also = number of polar rings
    b1 = 3 * nside - 1  # last belt ring, inclusive
    n_belt = b1 - b0 + 1  # 2*nside + 1... see assert below
    assert n_belt == 2 * nside + 1 and int(rings["n_pix"][b0]) == N and int(rings["n_pix"][b1]) == N
    start_belt = int(rings["start"][b0])
    m_arr = np.arange(lmax + 1)
    phi0 = rings["shift"][b0 : b1 + 1] * (2 * np.pi / N)
    phase = np.exp(1j * m_arr[:, None] * phi0[None, :]).astype(np.complex64)  # (L, n_belt)
    return {
        "N": N, "b0": b0, "b1": b1, "n_belt": n_belt, "nh": nh,
        "n_rings": n_rings, "start_belt": start_belt, "npol": nside - 1,
        "phase": phase,
    }


def _belt_g(g_n, g_s, bt):
    """Belt columns, in ring order, from the north/south accumulators."""
    north = g_n[..., bt["b0"] : bt["nh"]]
    south = jnp.flip(g_s[..., bt["b0"] : bt["nh"] - 1], axis=-1)
    return jnp.concatenate([north, south], axis=-1)  # (..., L, n_belt)


def _belt_synth(g_pos, g_neg, bt, lmax):
    """Device belt synthesis: ring values (..., n_belt, N) complex64.

    g_pos multiplies e^{+im phi}; conj(g_neg) goes at the -m frequencies
    (g_neg = g_pos for a real scalar field)."""
    N, L = bt["N"], lmax + 1
    phase = jnp.asarray(bt["phase"])
    wp = jnp.swapaxes(g_pos * phase, -1, -2)  # (..., n_belt, L)
    wn = jnp.conj(jnp.swapaxes(g_neg * phase, -1, -2))
    F = jnp.zeros((*wp.shape[:-1], N), dtype=jnp.complex64)
    F = F.at[..., :L].set(wp)
    F = F.at[..., N - lmax :].add(jnp.flip(wn[..., 1:], axis=-1))
    return jnp.fft.ifft(F, axis=-1) * N


def _belt_anal(belt_vals, bt, lmax, conj_input=False):
    """Device belt analysis: h[..., L, n_belt] = sum_j vals e^{-im phi_j}."""
    x = jnp.conj(belt_vals) if conj_input else belt_vals
    F = jnp.fft.fft(x.astype(jnp.complex64), axis=-1)  # (..., n_belt, N)
    h = jnp.swapaxes(F[..., : lmax + 1], -1, -2)  # (..., L, n_belt), no aliasing
    return h * jnp.conj(jnp.asarray(bt["phase"]))


def _h_layout(h_pol_n, h_pol_s, h_belt, bt):
    """(h_north, h_south) in (L, nh) accumulator layout from polar (host)
    and belt (device) pieces; the equator column of h_south is zero."""
    nb_north = bt["nh"] - bt["b0"]  # belt rings in the northern half
    belt_n = h_belt[..., :nb_north]
    belt_s = jnp.flip(h_belt[..., nb_north:], axis=-1)
    zero_eq = jnp.zeros((*belt_s.shape[:-1], 1), belt_s.dtype)
    h_n = jnp.concatenate([jnp.asarray(h_pol_n), belt_n], axis=-1)
    h_s = jnp.concatenate([jnp.asarray(h_pol_s), belt_s, zero_eq], axis=-1)
    return h_n, h_s


# --------------------------------------------------------------------------
# host-side polar ring assembly (short, aliased rings only)
# --------------------------------------------------------------------------
def _fold(w, n):
    """F[j] = sum_{m: m % n == j} w[..., m] without ufunc.at."""
    L = w.shape[-1]
    k = -(-L // n)
    pad = k * n - L
    wp = np.pad(w, [*[(0, 0)] * (w.ndim - 1), (0, pad)])
    return wp.reshape(*w.shape[:-1], k, n).sum(axis=-2)


def _polar_ring_params(nside, r):
    """(n_pix, phi0) of 0-based polar-cap ring r (same both hemispheres)."""
    n = 4 * (r + 1)
    return n, 0.5 * (2 * np.pi / n)


def _polar_synth(gp_n, gn_n, gp_s, gn_s, nside, lmax, complex_out=False):
    """Host synthesis of the polar caps. gp_* multiply e^{+im phi},
    conj(gn_*) fills the -m side. Returns (north_flat, south_flat)."""
    npol = nside - 1
    m_arr = np.arange(lmax + 1)
    batch = gp_n.shape[:-2]
    n_pix_cap = 2 * npol * (npol + 1)
    dt = complex if complex_out else float
    north = np.empty((*batch, n_pix_cap), dtype=dt)
    south = np.empty((*batch, n_pix_cap), dtype=dt)
    off_n = 0
    for r in range(npol):
        n, phi0 = _polar_ring_params(nside, r)
        phase = np.exp(1j * m_arr * phi0)
        idx_rev = (-np.arange(n)) % n
        for block, gp, gn in ((north, gp_n, gn_n), (south, gp_s, gn_s)):
            wp = gp[..., r] * phase
            wn = np.conj(gn[..., r] * phase)
            wn[..., 0] = 0.0  # m = 0 counted once
            F = _fold(wp, n) + _fold(wn, n)[..., idx_rev]
            vals = np.fft.ifft(F, axis=-1) * n
            block[..., off_n : off_n + n] = vals if complex_out else vals.real
        off_n += n
    # the southern cap is stored pole-last: ring order there is the
    # REVERSE of our mirror-index order
    south_blocks = []
    off = n_pix_cap
    for r in range(npol - 1, -1, -1):
        n = 4 * (r + 1)
        off -= n
        south_blocks.append(south[..., off : off + n])
    south_out = np.concatenate(south_blocks, axis=-1) if npol else south
    return north, south_out


def _polar_anal(north_flat, south_flat, nside, lmax, conj_input=False):
    """Host analysis of the polar caps -> (h_pol_n, h_pol_s), each
    (..., L, nside-1) complex64."""
    npol = nside - 1
    L = lmax + 1
    m_arr = np.arange(L)
    batch = north_flat.shape[:-1]
    h_n = np.zeros((*batch, L, npol), dtype=np.complex64)
    h_s = np.zeros((*batch, L, npol), dtype=np.complex64)
    n_pix_cap = north_flat.shape[-1]
    off_n = 0
    off_s = n_pix_cap
    for r in range(npol):
        n, phi0 = _polar_ring_params(nside, r)
        xn = north_flat[..., off_n : off_n + n]
        xs = south_flat[..., off_s - n : off_s]
        if conj_input:
            xn, xs = np.conj(xn), np.conj(xs)
        for h, x in ((h_n, xn), (h_s, xs)):
            F = np.fft.fft(x, axis=-1)
            h[..., r] = F[..., m_arr % n] * np.exp(-1j * m_arr * phi0)
        off_n += n
        off_s -= n
    return h_n, h_s


# --------------------------------------------------------------------------
# fused device transforms (scan + belt FFT in one jit)
# --------------------------------------------------------------------------
def _lane_tables(lmax: int, nside: int, spin: int):
    alpha, beta, gamma = _recursion_tables(lmax, abs(spin))
    seed_val, seed_exp, seed_step = _seed_tables(lmax, nside, spin)
    L = lmax + 1
    return {
        "alpha": jnp.asarray(alpha),
        "beta": jnp.asarray(beta),
        "gamma": jnp.asarray(gamma),
        "seed_val": jnp.asarray(seed_val),
        "seed_exp": jnp.asarray(seed_exp),
        "seed_mask": jnp.asarray(seed_step)[None, :] == jnp.arange(L)[:, None],
    }


def _sign_tables(lmax: int):
    L = lmax + 1
    norm = _norm_l(lmax)
    msign = (-1.0) ** np.arange(L)
    lsign = (-1.0) ** np.arange(L)
    cn = (norm[:, None] * msign[None, :]).astype(np.float32)  # northern streams
    cs = (norm[:, None] * lsign[:, None] * np.ones((1, L))).astype(np.float32)
    return jnp.asarray(cn), jnp.asarray(cs)


@lru_cache(maxsize=16)
def _alm2map_fn(lmax: int, nside: int):
    L = lmax + 1
    _, nh, z_n = _ring_geometry(nside)
    bt = _belt_tables(nside, lmax)
    # tables ride as jit ARGUMENTS: embedding them as closure constants
    # bakes tens of MB into the HLO at nside>=512, which slows every
    # compile
    tables = {
        "t": _lane_tables(lmax, nside, 0),
        "signs": _sign_tables(lmax),
        "z": jnp.asarray(z_n, jnp.float32),
        "phase_re": jnp.asarray(np.real(bt["phase"]), jnp.float32),
        "phase_im": jnp.asarray(np.imag(bt["phase"]), jnp.float32),
    }
    bt_static = {k: v for k, v in bt.items() if k != "phase"}

    def fn(a_re, a_im, tb):
        t, z = tb["t"], tb["z"]
        cn_f, cs_f = tb["signs"]
        bt = {**bt_static, "phase": tb["phase_re"] + 1j * tb["phase_im"]}
        rows = (a_re * cn_f, a_im * cn_f, a_re * cs_f, a_im * cs_f)
        acc0 = tuple(jnp.zeros((L, nh), jnp.float32) for _ in range(4))

        def body(carry, xs):
            lane, acc = carry
            a_r, g_r, smask, row = xs
            lane, contrib = _lane_step(
                lane, a_r, jnp.zeros_like(a_r), g_r, smask, z, t["seed_val"], t["seed_exp"]
            )
            acc = tuple(g + r[:, None] * contrib for g, r in zip(acc, row))
            return (lane, acc), None

        xs = (t["alpha"], t["gamma"], t["seed_mask"], rows)
        (_, acc), _ = jax.lax.scan(body, (_zero_lane(L, nh), acc0), xs)
        g_n = acc[0] + 1j * acc[1]
        g_s = acc[2] + 1j * acc[3]
        belt = _belt_synth(_belt_g(g_n, g_s, bt), _belt_g(g_n, g_s, bt), bt, lmax).real
        npol = bt["npol"]
        # polar g goes out as f32 re/im slices (the host assembles the
        # polar rings from them)
        return belt.astype(jnp.float32), tuple(a[:, :npol] for a in acc)

    jfn = jax.jit(fn)
    return lambda a_re, a_im: jfn(a_re, a_im, tables)


@lru_cache(maxsize=16)
def _map2alm_fn(lmax: int, nside: int):
    L = lmax + 1
    _, nh, z_n = _ring_geometry(nside)
    bt = _belt_tables(nside, lmax)
    tables = {
        "t": _lane_tables(lmax, nside, 0),
        "signs": _sign_tables(lmax),
        "z": jnp.asarray(z_n, jnp.float32),
        "phase_re": jnp.asarray(np.real(bt["phase"]), jnp.float32),
        "phase_im": jnp.asarray(np.imag(bt["phase"]), jnp.float32),
    }
    bt_static = {k: v for k, v in bt.items() if k != "phase"}

    def fn(belt_vals, hn_re, hn_im, hs_re, hs_im, tb):
        t, z = tb["t"], tb["z"]
        cn_f, cs_f = tb["signs"]
        bt = {**bt_static, "phase": tb["phase_re"] + 1j * tb["phase_im"]}
        h_belt = _belt_anal(belt_vals, bt, lmax)
        h_n, h_s = _h_layout(hn_re + 1j * hn_im, hs_re + 1j * hs_im, h_belt, bt)
        streams = (h_n.real, h_n.imag, h_s.real, h_s.imag)

        def body(lane, xs):
            a_r, g_r, smask = xs
            lane, contrib = _lane_step(
                lane, a_r, jnp.zeros_like(a_r), g_r, smask, z, t["seed_val"], t["seed_exp"]
            )
            ys = tuple(jnp.sum(contrib * h, axis=-1) for h in streams)
            return lane, ys

        _, ys = jax.lax.scan(body, _zero_lane(L, nh), (t["alpha"], t["gamma"], t["seed_mask"]))
        omega = 4 * np.pi / nside2npix(nside)
        tri = jnp.tril(jnp.ones((L, L), jnp.float32))
        alm_re = omega * (cn_f * ys[0] + cs_f * ys[2]) * tri
        alm_im = omega * (cn_f * ys[1] + cs_f * ys[3]) * tri
        return alm_re, alm_im

    jfn = jax.jit(fn)
    return lambda *args: jfn(*args, tables)


@lru_cache(maxsize=16)
def _alm2map_spin_fn(lmax: int, nside: int):
    L = lmax + 1
    _, nh, z_n = _ring_geometry(nside)
    bt = _belt_tables(nside, lmax)
    tables = {
        "tp": _lane_tables(lmax, nside, 2),
        "tm": _lane_tables(lmax, nside, -2),
        "signs": _sign_tables(lmax),
        "z": jnp.asarray(z_n, jnp.float32),
        "phase_re": jnp.asarray(np.real(bt["phase"]), jnp.float32),
        "phase_im": jnp.asarray(np.imag(bt["phase"]), jnp.float32),
    }
    bt_static = {k: v for k, v in bt.items() if k != "phase"}

    def fn(e_re, e_im, b_re, b_im, tb):
        tp, tm, z = tb["tp"], tb["tm"], tb["z"]
        cn_f, cs_f = tb["signs"]
        bt = {**bt_static, "phase": tb["phase_re"] + 1j * tb["phase_im"]}
        # a2 = -(aE + i aB), am2 = -(aE - i aB), scaled by the
        # north ((-1)^m norm) / south ((-1)^l norm) stream factors
        a2_re, a2_im = -(e_re - b_im), -(e_im + b_re)
        am2_re, am2_im = -(e_re + b_im), -(e_im - b_re)
        rows = (
            a2_re * cn_f, a2_im * cn_f,      # b2 north   (x dp)
            am2_re * cn_f, am2_im * cn_f,    # bm2 north  (x dm)
            a2_re * cs_f, a2_im * cs_f,      # b2 south   (x dm)
            am2_re * cs_f, am2_im * cs_f,    # bm2 south  (x dp)
        )
        acc0 = tuple(jnp.zeros((L, nh), jnp.float32) for _ in range(8))

        def body(carry, xs):
            lane_p, lane_m, acc = carry
            a_r, b_r, g_r, smask, row = xs
            lane_p, dp = _lane_step(lane_p, a_r, b_r, g_r, smask, z, tp["seed_val"], tp["seed_exp"])
            lane_m, dm = _lane_step(lane_m, a_r, -b_r, g_r, smask, z, tm["seed_val"], tm["seed_exp"])
            acc = (
                acc[0] + row[0][:, None] * dp, acc[1] + row[1][:, None] * dp,
                acc[2] + row[2][:, None] * dm, acc[3] + row[3][:, None] * dm,
                acc[4] + row[4][:, None] * dm, acc[5] + row[5][:, None] * dm,
                acc[6] + row[6][:, None] * dp, acc[7] + row[7][:, None] * dp,
            )
            return (lane_p, lane_m, acc), None

        xs = (tp["alpha"], tp["beta"], tp["gamma"], tp["seed_mask"], rows)
        (_, _, acc), _ = jax.lax.scan(body, (_zero_lane(L, nh), _zero_lane(L, nh), acc0), xs)
        gp_n = acc[0] + 1j * acc[1]
        gm_n = acc[2] + 1j * acc[3]
        gp_s = acc[4] + 1j * acc[5]
        gm_s = acc[6] + 1j * acc[7]
        belt = _belt_synth(_belt_g(gp_n, gp_s, bt), _belt_g(gm_n, gm_s, bt), bt, lmax)
        npol = bt["npol"]
        return belt.real, belt.imag, tuple(a[:, :npol] for a in acc)

    jfn = jax.jit(fn)
    return lambda *args: jfn(*args, tables)


@lru_cache(maxsize=16)
def _map2alm_spin_fn(lmax: int, nside: int):
    L = lmax + 1
    _, nh, z_n = _ring_geometry(nside)
    bt = _belt_tables(nside, lmax)
    tables = {
        "tp": _lane_tables(lmax, nside, 2),
        "tm": _lane_tables(lmax, nside, -2),
        "signs": _sign_tables(lmax),
        "z": jnp.asarray(z_n, jnp.float32),
        "phase_re": jnp.asarray(np.real(bt["phase"]), jnp.float32),
        "phase_im": jnp.asarray(np.imag(bt["phase"]), jnp.float32),
    }
    bt_static = {k: v for k, v in bt.items() if k != "phase"}

    def fn(belt_Q, belt_U, h_pol, tb):
        tp, tm, z = tb["tp"], tb["tm"], tb["z"]
        cn_f, cs_f = tb["signs"]
        bt = {**bt_static, "phase": tb["phase_re"] + 1j * tb["phase_im"]}
        belt_P = belt_Q + 1j * belt_U
        hp_belt = _belt_anal(belt_P, bt, lmax)
        hm_belt = _belt_anal(belt_P, bt, lmax, conj_input=True)
        hp_n, hp_s = _h_layout(h_pol[0] + 1j * h_pol[1], h_pol[2] + 1j * h_pol[3], hp_belt, bt)
        hm_n, hm_s = _h_layout(h_pol[4] + 1j * h_pol[5], h_pol[6] + 1j * h_pol[7], hm_belt, bt)
        streams = (
            hp_n.real, hp_n.imag, hp_s.real, hp_s.imag,
            hm_n.real, hm_n.imag, hm_s.real, hm_s.imag,
        )

        def body(carry, xs):
            lane_p, lane_m = carry
            a_r, b_r, g_r, smask = xs
            lane_p, dp = _lane_step(lane_p, a_r, b_r, g_r, smask, z, tp["seed_val"], tp["seed_exp"])
            lane_m, dm = _lane_step(lane_m, a_r, -b_r, g_r, smask, z, tm["seed_val"], tm["seed_exp"])
            ys = (
                jnp.sum(dp * streams[0], -1), jnp.sum(dp * streams[1], -1),
                jnp.sum(dm * streams[2], -1), jnp.sum(dm * streams[3], -1),
                jnp.sum(dm * streams[4], -1), jnp.sum(dm * streams[5], -1),
                jnp.sum(dp * streams[6], -1), jnp.sum(dp * streams[7], -1),
            )
            return (lane_p, lane_m), ys

        _, ys = jax.lax.scan(
            body, (_zero_lane(L, nh), _zero_lane(L, nh)),
            (tp["alpha"], tp["beta"], tp["gamma"], tp["seed_mask"]),
        )
        omega = 4 * np.pi / nside2npix(nside)
        a2_re = omega * (cn_f * ys[0] + cs_f * ys[2])
        a2_im = omega * (cn_f * ys[1] + cs_f * ys[3])
        am2_re = omega * (cn_f * ys[4] + cs_f * ys[6])
        am2_im = omega * (cn_f * ys[5] + cs_f * ys[7])
        tri = jnp.tril(jnp.ones((L, L), jnp.float32))
        # aE = -(a2 + am2)/2 ; aB = i (a2 - am2)/2
        aE_re = -(a2_re + am2_re) / 2 * tri
        aE_im = -(a2_im + am2_im) / 2 * tri
        aB_re = -(a2_im - am2_im) / 2 * tri
        aB_im = (a2_re - am2_re) / 2 * tri
        return aE_re, aE_im, aB_re, aB_im

    jfn = jax.jit(fn)
    return lambda *args: jfn(*args, tables)


# --------------------------------------------------------------------------
# public transforms
# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# native (OpenMP) CPU path: same recursion in C++ (healpix/_sht_native.cpp),
# parallel over rings/m and exploiting the m <= l triangle. Used when the
# native kernels compiled; the device scan is the fallback.
# --------------------------------------------------------------------------
def _use_native() -> bool:
    # The SHT is host-side scene setup (sky synthesis/analysis before
    # the fused device program), so the native kernels are preferred
    # whenever they compiled, also next to an accelerator, where they
    # skip a compile per (lmax, nside); which side is faster there is
    # not measured. The jax scan remains the fallback (no toolchain /
    # MARIA_TPU_SHT_NATIVE=0).
    from . import native

    return native.available()


@lru_cache(maxsize=16)
def _host_tables(lmax: int, nside: int, spin: int) -> dict:
    alpha, beta, gamma = _recursion_tables(lmax, spin)
    seed_val, seed_exp, seed_step = _seed_tables(lmax, nside, spin)
    _, nh, z_n = _ring_geometry(nside)
    return {
        "alpha": alpha, "beta": beta, "gamma": gamma,
        "seed_val": seed_val, "seed_exp": seed_exp, "seed_step": seed_step,
        "z": z_n.astype(np.float32),
    }


@lru_cache(maxsize=16)
def _sign_tables_np(lmax: int):
    L = lmax + 1
    norm = _norm_l(lmax)
    msign = (-1.0) ** np.arange(L)
    lsign = (-1.0) ** np.arange(L)
    cn = (norm[:, None] * msign[None, :]).astype(np.float32)
    cs = (norm[:, None] * lsign[:, None] * np.ones((1, L))).astype(np.float32)
    return cn, cs


def _belt_g_np(g_n, g_s, bt):
    north = g_n[..., bt["b0"] : bt["nh"]]
    south = np.flip(g_s[..., bt["b0"] : bt["nh"] - 1], axis=-1)
    return np.concatenate([north, south], axis=-1)


def _belt_synth_np(g_pos, g_neg, bt, lmax):
    N, L = bt["N"], lmax + 1
    phase = np.asarray(bt["phase"])
    wp = np.swapaxes(g_pos * phase, -1, -2)
    wn = np.conj(np.swapaxes(g_neg * phase, -1, -2))
    F = np.zeros((*wp.shape[:-1], N), dtype=np.complex64)
    F[..., :L] = wp
    F[..., N - lmax :] += wn[..., 1:][..., ::-1]
    return np.fft.ifft(F, axis=-1) * N


def _belt_anal_np(belt_vals, bt, lmax, conj_input=False):
    x = np.conj(belt_vals) if conj_input else belt_vals
    F = np.fft.fft(np.asarray(x, dtype=np.complex64), axis=-1)
    h = np.swapaxes(F[..., : lmax + 1], -1, -2)
    return h * np.conj(np.asarray(bt["phase"]))


def _h_layout_np(h_pol_n, h_pol_s, h_belt, bt):
    nb_north = bt["nh"] - bt["b0"]
    belt_n = h_belt[..., :nb_north]
    belt_s = np.flip(h_belt[..., nb_north:], axis=-1)
    zero_eq = np.zeros((*belt_s.shape[:-1], 1), belt_s.dtype)
    h_n = np.concatenate([np.asarray(h_pol_n), belt_n], axis=-1)
    h_s = np.concatenate([np.asarray(h_pol_s), belt_s, zero_eq], axis=-1)
    return h_n, h_s


def _alm2map_native(a: np.ndarray, nside: int) -> np.ndarray:
    """Scalar synthesis for one (L, L) alm on the native CPU kernels."""
    from . import native

    lmax = a.shape[-2] - 1
    t = _host_tables(lmax, nside, 0)
    cn, cs = _sign_tables_np(lmax)
    bt = _belt_tables(nside, lmax)
    a_re = np.asarray(a.real, dtype=np.float32)
    a_im = np.asarray(a.imag, dtype=np.float32)
    rows = np.stack([a_re * cn, a_im * cn, a_re * cs, a_im * cs])
    acc = native.synth(t, rows)
    g_n = acc[0].astype(np.complex64) + 1j * acc[1]
    g_s = acc[2].astype(np.complex64) + 1j * acc[3]
    belt = _belt_synth_np(_belt_g_np(g_n, g_s, bt), _belt_g_np(g_n, g_s, bt), bt, lmax).real
    npol = bt["npol"]
    north, south = _polar_synth(g_n[:, :npol], g_n[:, :npol], g_s[:, :npol], g_s[:, :npol], nside, lmax)
    return np.concatenate(
        [north.astype(np.float32), belt.reshape(-1).astype(np.float32), south.astype(np.float32)],
        axis=-1,
    )


def _map2alm_native(md: np.ndarray, lmax: int, nside: int) -> np.ndarray:
    from . import native

    t = _host_tables(lmax, nside, 0)
    cn, cs = _sign_tables_np(lmax)
    bt = _belt_tables(nside, lmax)
    s0, nb, N = bt["start_belt"], bt["n_belt"], bt["N"]
    belt = md[s0 : s0 + nb * N].reshape(nb, N)
    h_pol_n, h_pol_s = _polar_anal(md[:s0][None], md[s0 + nb * N :][None], nside, lmax)
    h_belt = _belt_anal_np(belt, bt, lmax)
    h_n, h_s = _h_layout_np(h_pol_n[0], h_pol_s[0], h_belt, bt)
    streams = np.stack([h_n.real, h_n.imag, h_s.real, h_s.imag]).astype(np.float32)
    ys = native.anal(t, streams)
    omega = 4 * np.pi / nside2npix(nside)
    tri = np.tril(np.ones((lmax + 1, lmax + 1), dtype=np.float32))
    alm_re = omega * (cn * ys[0] + cs * ys[2]) * tri
    alm_im = omega * (cn * ys[1] + cs * ys[3]) * tri
    return (alm_re + 1j * alm_im).astype(np.complex64)


def _alm2map_spin_native(e: np.ndarray, b: np.ndarray, nside: int):
    from . import native

    lmax = e.shape[-2] - 1
    tp = _host_tables(lmax, nside, 2)
    tm = _host_tables(lmax, nside, -2)
    cn, cs = _sign_tables_np(lmax)
    bt = _belt_tables(nside, lmax)
    e_re, e_im = np.asarray(e.real, np.float32), np.asarray(e.imag, np.float32)
    b_re, b_im = np.asarray(b.real, np.float32), np.asarray(b.imag, np.float32)
    a2_re, a2_im = -(e_re - b_im), -(e_im + b_re)
    am2_re, am2_im = -(e_re + b_im), -(e_im - b_re)
    # dp multiplies streams (0,1,6,7) of the device ordering; dm (2,3,4,5)
    acc_p = native.synth(tp, np.stack([a2_re * cn, a2_im * cn, am2_re * cs, am2_im * cs]))
    acc_m = native.synth(tm, np.stack([am2_re * cn, am2_im * cn, a2_re * cs, a2_im * cs]))
    gp_n = acc_p[0].astype(np.complex64) + 1j * acc_p[1]
    gp_s = acc_m[2].astype(np.complex64) + 1j * acc_m[3]
    gm_n = acc_m[0].astype(np.complex64) + 1j * acc_m[1]
    gm_s = acc_p[2].astype(np.complex64) + 1j * acc_p[3]
    belt = _belt_synth_np(_belt_g_np(gp_n, gp_s, bt), _belt_g_np(gm_n, gm_s, bt), bt, lmax)
    npol = bt["npol"]
    north, south = _polar_synth(
        gp_n[:, :npol], gm_n[:, :npol], gp_s[:, :npol], gm_s[:, :npol],
        nside, lmax, complex_out=True,
    )
    Q = np.concatenate([north.real.astype(np.float32),
                        belt.real.reshape(-1).astype(np.float32),
                        south.real.astype(np.float32)], axis=-1)
    U = np.concatenate([north.imag.astype(np.float32),
                        belt.imag.reshape(-1).astype(np.float32),
                        south.imag.astype(np.float32)], axis=-1)
    return Q, U


def _map2alm_spin_native(Qm: np.ndarray, Um: np.ndarray, lmax: int, nside: int):
    from . import native

    tp = _host_tables(lmax, nside, 2)
    tm = _host_tables(lmax, nside, -2)
    cn, cs = _sign_tables_np(lmax)
    bt = _belt_tables(nside, lmax)
    s0, nb, N = bt["start_belt"], bt["n_belt"], bt["N"]
    P = Qm.astype(np.complex64) + 1j * Um.astype(np.complex64)
    belt_P = P[s0 : s0 + nb * N].reshape(nb, N)
    hp_belt = _belt_anal_np(belt_P, bt, lmax)
    hm_belt = _belt_anal_np(belt_P, bt, lmax, conj_input=True)
    north, south = P[:s0][None], P[s0 + nb * N :][None]
    hp_n, hp_s = _polar_anal(north, south, nside, lmax)
    hm_n, hm_s = _polar_anal(north, south, nside, lmax, conj_input=True)
    hp_n2, hp_s2 = _h_layout_np(hp_n[0], hp_s[0], hp_belt, bt)
    hm_n2, hm_s2 = _h_layout_np(hm_n[0], hm_s[0], hm_belt, bt)
    # device ordering: dp * streams (0,1,6,7), dm * streams (2,3,4,5)
    ys_p = native.anal(tp, np.stack(
        [hp_n2.real, hp_n2.imag, hm_s2.real, hm_s2.imag]).astype(np.float32))
    ys_m = native.anal(tm, np.stack(
        [hp_s2.real, hp_s2.imag, hm_n2.real, hm_n2.imag]).astype(np.float32))
    omega = 4 * np.pi / nside2npix(nside)
    a2_re = omega * (cn * ys_p[0] + cs * ys_m[0])
    a2_im = omega * (cn * ys_p[1] + cs * ys_m[1])
    am2_re = omega * (cn * ys_m[2] + cs * ys_p[2])
    am2_im = omega * (cn * ys_m[3] + cs * ys_p[3])
    tri = np.tril(np.ones((lmax + 1, lmax + 1), dtype=np.float32))
    aE_re = -(a2_re + am2_re) / 2 * tri
    aE_im = -(a2_im + am2_im) / 2 * tri
    aB_re = -(a2_im - am2_im) / 2 * tri
    aB_im = (a2_re - am2_re) / 2 * tri
    return (aE_re + 1j * aE_im).astype(np.complex64), (aB_re + 1j * aB_im).astype(np.complex64)


def _check_lmax(lmax, nside):
    if lmax >= 4 * nside:
        raise ValueError(f"lmax={lmax} >= 4*nside={4 * nside}: belt rings would alias.")


def _split_ri(a):
    a = np.asarray(a, dtype=np.complex64)
    return jnp.asarray(a.real), jnp.asarray(a.imag)


def _as_batched(x, inner_ndim):
    """(array, batch_shape, had_batch) with leading dims flattened to one."""
    batch = x.shape[: x.ndim - inner_ndim]
    if batch:
        x = x.reshape(-1, *x.shape[x.ndim - inner_ndim :])
    return x, batch


def alm2map(alm, nside: int):
    """Synthesize real HEALPix RING map(s) from a_lm indexed (..., l, m).

    Returns a device (jnp) array, shape (..., npix)."""
    if hasattr(alm, "device_buffer") or isinstance(alm, jnp.ndarray):
        alm = jnp.asarray(alm, dtype=jnp.complex64)
        a_re, a_im = jnp.real(alm), jnp.imag(alm)
    else:
        a = np.asarray(alm, dtype=np.complex64)
        a_re, a_im = jnp.asarray(a.real), jnp.asarray(a.imag)
    lmax = a_re.shape[-2] - 1
    _check_lmax(lmax, nside)
    a_re, batch = _as_batched(a_re, 2)
    a_im, _ = _as_batched(a_im, 2)
    if _use_native():
        a_np = np.asarray(a_re, np.float32) + 1j * np.asarray(a_im, np.float32)
        if batch:
            out = np.stack([_alm2map_native(x, nside) for x in a_np])
            return jnp.asarray(out.reshape(*batch, -1))
        return jnp.asarray(_alm2map_native(a_np, nside))
    fn = _alm2map_fn(lmax, nside)
    if batch:
        fn = jax.vmap(fn)
    belt, acc = fn(a_re, a_im)
    gnp = np.asarray(acc[0], dtype=float) + 1j * np.asarray(acc[1], dtype=float)
    gsp = np.asarray(acc[2], dtype=float) + 1j * np.asarray(acc[3], dtype=float)
    north, south = _polar_synth(gnp, gnp, gsp, gsp, nside, lmax)
    belt_flat = belt.reshape(*belt.shape[:-2], -1)
    out = jnp.concatenate(
        [jnp.asarray(north.astype(np.float32)), belt_flat, jnp.asarray(south.astype(np.float32))],
        axis=-1,
    )
    return out.reshape(*batch, -1) if batch else out


def map2alm(m, lmax: int):
    """Analyze real HEALPix RING map(s) (..., npix) -> a_lm (..., l, m).

    Uses the straightforward Omega * sum quadrature (like healpy with
    iter=0); band-limited fields round-trip to ~0.2%."""
    nside = int(round(np.sqrt(np.shape(m)[-1] / 12)))
    _check_lmax(lmax, nside)
    if _use_native():
        md_np = np.asarray(m, dtype=np.float32)
        md_np, batch = _as_batched(md_np, 1)
        if batch:
            alm = np.stack([_map2alm_native(x, lmax, nside) for x in md_np])
            return jnp.asarray(alm.reshape(*batch, lmax + 1, lmax + 1))
        return jnp.asarray(_map2alm_native(md_np, lmax, nside))
    bt = _belt_tables(nside, lmax)
    md = jnp.asarray(m, dtype=jnp.float32)
    md, batch = _as_batched(md, 1)
    s0, nb, N = bt["start_belt"], bt["n_belt"], bt["N"]
    belt = md[..., s0 : s0 + nb * N].reshape(*md.shape[:-1], nb, N)
    north = np.asarray(md[..., :s0], dtype=float)
    south = np.asarray(md[..., s0 + nb * N :], dtype=float)
    h_pol_n, h_pol_s = _polar_anal(north, south, nside, lmax)
    fn = _map2alm_fn(lmax, nside)
    if batch:
        fn = jax.vmap(fn)
    alm_re, alm_im = fn(
        belt,
        jnp.asarray(h_pol_n.real.astype(np.float32)), jnp.asarray(h_pol_n.imag.astype(np.float32)),
        jnp.asarray(h_pol_s.real.astype(np.float32)), jnp.asarray(h_pol_s.imag.astype(np.float32)),
    )
    alm = alm_re + 1j * alm_im
    return alm.reshape(*batch, lmax + 1, lmax + 1) if batch else alm


def alm2map_spin(alm_e, alm_b, nside: int):
    """Spin-2 synthesis: (aE, aB) indexed (..., l, m) -> (Q, U) maps.

    Convention: Q + iU = -sum (aE + i aB) 2Y_lm (healpy COSMO). Matches
    the reference's healpy-based IQU generation
    (maria/cmb/generation.py:47-56). Returns device (jnp) arrays."""
    e = np.asarray(alm_e, dtype=np.complex64) if not isinstance(alm_e, jnp.ndarray) else jnp.asarray(alm_e, jnp.complex64)
    b = np.asarray(alm_b, dtype=np.complex64) if not isinstance(alm_b, jnp.ndarray) else jnp.asarray(alm_b, jnp.complex64)
    e_re, e_im = (jnp.real(e), jnp.imag(e)) if isinstance(e, jnp.ndarray) else (jnp.asarray(e.real), jnp.asarray(e.imag))
    b_re, b_im = (jnp.real(b), jnp.imag(b)) if isinstance(b, jnp.ndarray) else (jnp.asarray(b.real), jnp.asarray(b.imag))
    lmax = e_re.shape[-2] - 1
    _check_lmax(lmax, nside)
    e_re, batch = _as_batched(e_re, 2)
    e_im, _ = _as_batched(e_im, 2)
    b_re, _ = _as_batched(b_re, 2)
    b_im, _ = _as_batched(b_im, 2)
    if _use_native():
        e_np = np.asarray(e_re, np.float32) + 1j * np.asarray(e_im, np.float32)
        b_np = np.asarray(b_re, np.float32) + 1j * np.asarray(b_im, np.float32)
        if batch:
            QU = [_alm2map_spin_native(x, y, nside) for x, y in zip(e_np, b_np)]
            Q = np.stack([q for q, _ in QU]).reshape(*batch, -1)
            U = np.stack([u for _, u in QU]).reshape(*batch, -1)
            return jnp.asarray(Q), jnp.asarray(U)
        Q, U = _alm2map_spin_native(e_np, b_np, nside)
        return jnp.asarray(Q), jnp.asarray(U)
    fn = _alm2map_spin_fn(lmax, nside)
    if batch:
        fn = jax.vmap(fn)
    belt_re, belt_im, acc = fn(e_re, e_im, b_re, b_im)
    a = [np.asarray(x, dtype=float) for x in acc]
    north, south = _polar_synth(
        a[0] + 1j * a[1], a[2] + 1j * a[3], a[4] + 1j * a[5], a[6] + 1j * a[7],
        nside, lmax, complex_out=True,
    )
    Q = jnp.concatenate(
        [jnp.asarray(north.real.astype(np.float32)),
         belt_re.reshape(*belt_re.shape[:-2], -1),
         jnp.asarray(south.real.astype(np.float32))], axis=-1)
    U = jnp.concatenate(
        [jnp.asarray(north.imag.astype(np.float32)),
         belt_im.reshape(*belt_im.shape[:-2], -1),
         jnp.asarray(south.imag.astype(np.float32))], axis=-1)
    if batch:
        Q = Q.reshape(*batch, -1)
        U = U.reshape(*batch, -1)
    return Q, U


def map2alm_spin(Q, U, lmax: int):
    """Spin-2 analysis: (Q, U) maps (..., npix) -> (aE, aB) on device."""
    nside = int(round(np.sqrt(np.shape(Q)[-1] / 12)))
    _check_lmax(lmax, nside)
    if _use_native():
        Qn = np.asarray(Q, np.float32)
        Un = np.asarray(U, np.float32)
        Qn, batch = _as_batched(Qn, 1)
        Un, _ = _as_batched(Un, 1)
        if batch:
            EB = [_map2alm_spin_native(q, u, lmax, nside) for q, u in zip(Qn, Un)]
            aE = np.stack([e for e, _ in EB]).reshape(*batch, lmax + 1, lmax + 1)
            aB = np.stack([b for _, b in EB]).reshape(*batch, lmax + 1, lmax + 1)
            return jnp.asarray(aE), jnp.asarray(aB)
        aE, aB = _map2alm_spin_native(Qn, Un, lmax, nside)
        return jnp.asarray(aE), jnp.asarray(aB)
    bt = _belt_tables(nside, lmax)
    Qd = jnp.asarray(Q, jnp.float32)
    Ud = jnp.asarray(U, jnp.float32)
    Qd, batch = _as_batched(Qd, 1)
    Ud, _ = _as_batched(Ud, 1)
    s0, nb, N = bt["start_belt"], bt["n_belt"], bt["N"]
    belt_Q = Qd[..., s0 : s0 + nb * N].reshape(*Qd.shape[:-1], nb, N)
    belt_U = Ud[..., s0 : s0 + nb * N].reshape(*Ud.shape[:-1], nb, N)
    north = np.asarray(Qd[..., :s0], dtype=float) + 1j * np.asarray(Ud[..., :s0], dtype=float)
    south = (np.asarray(Qd[..., s0 + nb * N :], dtype=float)
             + 1j * np.asarray(Ud[..., s0 + nb * N :], dtype=float))
    hp_n, hp_s = _polar_anal(north, south, nside, lmax)
    hm_n, hm_s = _polar_anal(north, south, nside, lmax, conj_input=True)
    fn = _map2alm_spin_fn(lmax, nside)
    if batch:
        fn = jax.vmap(fn)
    h_pol = tuple(
        jnp.asarray(x, jnp.float32)
        for x in (hp_n.real, hp_n.imag, hp_s.real, hp_s.imag,
                  hm_n.real, hm_n.imag, hm_s.real, hm_s.imag)
    )
    aE_re, aE_im, aB_re, aB_im = fn(belt_Q, belt_U, h_pol)
    aE = aE_re + 1j * aE_im
    aB = aB_re + 1j * aB_im
    if batch:
        aE = aE.reshape(*batch, lmax + 1, lmax + 1)
        aB = aB.reshape(*batch, lmax + 1, lmax + 1)
    return aE, aB


@lru_cache(maxsize=8)
def _synalm_cmb_device_fn(lmax: int):
    L = lmax + 1
    tri = jnp.tril(jnp.ones((L, L), jnp.float32))
    half = jnp.where(jnp.arange(L)[None, :] == 0, 1.0, 1.0 / np.sqrt(2.0)) * tri

    def draw(key, cT, cTE, cE, cB):
        ks = jax.random.split(key, 6)

        def unit(kr, ki):
            re = jax.random.normal(kr, (L, L), jnp.float32) * half
            im = jax.random.normal(ki, (L, L), jnp.float32) * half
            return re + 1j * im.at[:, 0].set(0.0)  # m = 0 is real

        x1, x2, x3 = unit(ks[0], ks[1]), unit(ks[2], ks[3]), unit(ks[4], ks[5])
        aT = x1 * cT[:, None]
        aE = x1 * cTE[:, None] + x2 * cE[:, None]
        aB = x3 * cB[:, None]
        return aT, aE, aB

    return jax.jit(draw)


def synalm_cmb_device(spectra: dict, lmax: int, seed: int = 0):
    """Device-side correlated (aT, aE, aB) draw: only the O(lmax) Cl
    vectors cross the host boundary — feeds alm2map/alm2map_spin with
    zero-copy device alm (the nside=512 CMB path)."""

    def _cl(name):
        c = np.asarray(spectra.get(name, np.zeros(lmax + 1)), dtype=float)
        return np.pad(c[: lmax + 1], (0, max(0, lmax + 1 - len(c))))

    TT, EE, BB, TE = _cl("TT"), _cl("EE"), _cl("BB"), _cl("TE")
    cT = np.sqrt(np.clip(TT, 0, None))
    with np.errstate(divide="ignore", invalid="ignore"):
        cTE = np.where(cT > 0, TE / np.where(cT > 0, cT, 1.0), 0.0)
    cE = np.sqrt(np.clip(EE - cTE**2, 0, None))
    cB = np.sqrt(np.clip(BB, 0, None))
    fn = _synalm_cmb_device_fn(lmax)
    return fn(
        jax.random.key(seed),
        *(jnp.asarray(c, jnp.float32) for c in (cT, cTE, cE, cB)),
    )
