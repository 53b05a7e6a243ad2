"""Spin-2 SHT validation: recursion oracle (sympy), synthesis oracle
(scipy / brute-force Wigner-d), roundtrips, and polarized-CMB spectrum
recovery (VERDICT round-1 items #2/#3)."""

import numpy as np
import pytest

from maria_tpu.healpix import (
    alm2map,
    alm2map_spin,
    map2alm,
    map2alm_spin,
    nside2npix,
    synalm,
    synalm_cmb,
)
from maria_tpu.healpix.core import pix2ang_ring


def _d_num(l, mp, m, beta_arr):
    """sympy Wigner-d evaluated on an array of angles (oracle)."""
    from sympy import Symbol, lambdify
    from sympy.physics.quantum.spin import Rotation

    b = Symbol("b", real=True)
    f = lambdify(b, Rotation.d(l, mp, m, b).doit(), "numpy")
    return np.real(np.asarray(f(beta_arr), dtype=complex))


def test_scalar_synthesis_against_scipy():
    from scipy.special import sph_harm_y

    lmax, nside = 8, 16
    alm = synalm(np.ones(lmax + 1), seed=3)
    npix = nside2npix(nside)
    theta, phi = pix2ang_ring(nside, np.arange(npix))
    T = np.zeros(npix)
    for l in range(lmax + 1):
        T += (alm[l, 0] * sph_harm_y(l, 0, theta, phi)).real
        for m in range(1, l + 1):
            T += 2 * (alm[l, m] * sph_harm_y(l, m, theta, phi)).real
    ours = alm2map(alm, nside)
    assert np.abs(ours - T).max() / T.std() < 1e-4


def test_spin2_synthesis_against_wigner_oracle():
    """Q+iU = -sum (aE+iaB) 2Y_lm with 2Y from sympy Wigner-d, all m."""
    lmax, nside = 6, 8
    aE = synalm(np.ones(lmax + 1) * 0.5, seed=11)
    aB = synalm(np.ones(lmax + 1) * 0.3, seed=12)
    aE[:2] = 0
    aB[:2] = 0
    npix = nside2npix(nside)
    theta, phi = pix2ang_ring(nside, np.arange(npix))
    P = np.zeros(npix, dtype=complex)
    for l in range(2, lmax + 1):
        nrm = np.sqrt((2 * l + 1) / (4 * np.pi))
        for m in range(-l, l + 1):
            if m >= 0:
                a = aE[l, m] + 1j * aB[l, m]
            else:
                a = (-1) ** (-m) * np.conj(aE[l, -m] - 1j * aB[l, -m])
            Y = (-1) ** m * nrm * _d_num(l, -m, 2, theta) * np.exp(1j * m * phi)
            P += -a * Y
    Q, U = alm2map_spin(aE, aB, nside)
    sig = np.sqrt(P.real.std() ** 2 + P.imag.std() ** 2)
    assert np.abs(Q - P.real).max() / sig < 1e-4
    assert np.abs(U - P.imag).max() / sig < 1e-4


def test_spin2_roundtrip_power():
    lmax, nside = 24, 32
    aE = synalm(np.ones(lmax + 1) * 1e-2, seed=5)
    aB = synalm(np.ones(lmax + 1) * 3e-3, seed=6)
    aE[:2] = 0
    aB[:2] = 0
    Q, U = alm2map_spin(aE, aB, nside)
    aE2, aB2 = map2alm_spin(Q, U, lmax)
    for x, y in [(aE, aE2), (aB, aB2)]:
        p1 = (np.abs(x) ** 2)[2:16].sum(axis=1)
        p2 = (np.abs(y) ** 2)[2:16].sum(axis=1)
        assert np.allclose(p1, p2, rtol=0.05)
    # E does not leak into B (and vice versa) beyond quadrature error
    leak = (np.abs(aB2 - aB) ** 2)[2:16].sum() / (np.abs(aE) ** 2)[2:16].sum()
    assert leak < 1e-3


def test_batched_transforms_match_loop():
    lmax, nside = 12, 16
    alms = np.stack([synalm(np.ones(lmax + 1), seed=s) for s in range(3)])
    batched = alm2map(alms, nside)
    for i in range(3):
        single = alm2map(alms[i], nside)
        np.testing.assert_allclose(batched[i], single, atol=1e-6)
    back = map2alm(batched, lmax)
    assert back.shape == alms.shape


def test_synalm_cmb_te_correlation():
    """The (aT, aE) draw must carry the TE cross-spectrum."""
    lmax = 256
    ells = np.arange(lmax + 1, dtype=float)
    TT = np.zeros(lmax + 1)
    EE = np.zeros(lmax + 1)
    TE = np.zeros(lmax + 1)
    TT[2:] = 1.0 / ells[2:] ** 2
    EE[2:] = 0.3 / ells[2:] ** 2
    TE[2:] = 0.4 / ells[2:] ** 2  # r = 0.4/sqrt(0.3) ~ 0.73
    aT, aE, aB = synalm_cmb({"TT": TT, "EE": EE, "TE": TE}, lmax=lmax, seed=0)
    sl = slice(50, 250)
    te_hat = np.sum((aT[sl] * np.conj(aE[sl])).real, axis=1)
    n_modes = np.arange(lmax + 1)[sl] + 0.5
    r_hat = te_hat.sum() / np.sqrt(
        np.sum(np.abs(aT[sl]) ** 2) * np.sum(np.abs(aE[sl]) ** 2)
    )
    r_in = 0.4 / np.sqrt(0.3)
    assert abs(r_hat - r_in) < 0.1
    assert np.abs(np.sum((aT[sl] * np.conj(aB[sl])).real)) / np.sqrt(
        np.sum(np.abs(aT[sl]) ** 2) * max(np.sum(np.abs(aB[sl]) ** 2), 1e-30)
    ) < 0.1  # no T-B correlation
    del n_modes


def test_generate_cmb_polarized_spectra():
    """Recovered EE/BB pseudo-spectra of a generated IQU CMB match the
    input Cl within sample variance (VERDICT item #2 'done' criterion)."""
    from maria_tpu.cmb import generate_cmb, get_cmb_spectrum

    nside, lmax = 64, 128
    cmb = generate_cmb(nside=nside, lmax=lmax, seed=1)
    assert cmb.stokes == "IQU"
    T, Q, U = (np.asarray(cmb.data[i, 0, 0], dtype=float) for i in range(3))
    assert Q.std() > 0 and U.std() > 0  # polarization actually present
    spec = get_cmb_spectrum(lmax=lmax)

    aE, aB = map2alm_spin(Q, U, lmax)
    aT = map2alm(T, lmax)
    ells = np.arange(lmax + 1)
    for name, alm_hat in [("TT", aT), ("EE", aE), ("BB", aB)]:
        cl_in = spec[name][: lmax + 1]
        cl_hat = (np.abs(alm_hat) ** 2).sum(axis=1) * 2
        cl_hat -= np.abs(alm_hat[:, 0]) ** 2  # m=0 counted once
        cl_hat /= 2 * ells + 1
        # band-average l in [30, 90]: sample variance ~ sqrt(2/((2l+1) dl)) ~ 2%
        band = slice(30, 90)
        num, den = cl_hat[band].sum(), cl_in[band].sum()
        if den > 0:
            assert abs(num / den - 1) < 0.15, f"{name}: {num / den}"

    # TE correlation survives the map round trip
    band = slice(30, 90)
    te_hat = np.sum((aT[band] * np.conj(aE[band])).real)
    r = te_hat / np.sqrt(np.sum(np.abs(aT[band]) ** 2) * np.sum(np.abs(aE[band]) ** 2))
    te_in = spec["TE"][band].sum()
    r_in = te_in / np.sqrt(spec["TT"][band].sum() * spec["EE"][band].sum())
    assert abs(r - r_in) < 0.2


def test_healpix_smooth_iqu():
    """Spin-aware smoothing: narrows spectra, preserves Q/U rms scale."""
    from maria_tpu.cmb import generate_cmb

    cmb = generate_cmb(nside=32, lmax=64, seed=2)
    sm = cmb.smooth(np.radians(1.0))
    assert sm.data.shape == cmb.data.shape
    for i in range(3):
        a = np.asarray(cmb.data[i, 0, 0], dtype=float)
        b = np.asarray(sm.data[i, 0, 0], dtype=float)
        assert b.std() < a.std()  # smoothing removes power
        assert b.std() > 0.2 * a.std()  # but not all of it


def test_full_iqu_synthesis_wall_time():
    """generate_cmb at scale in seconds, not minutes: full IQU synthesis
    at nside=256 must be seconds-scale even on one CPU core (the native
    kernels; the device scan is the fallback). Logged so the number
    can be tracked."""
    import logging
    import time

    from maria_tpu.cmb import generate_cmb

    t0 = time.time()
    cmb = generate_cmb(nside=256, seed=123)
    dt = time.time() - t0
    logging.getLogger("maria_tpu").info(f"generate_cmb(nside=256): {dt:.1f} s")
    assert cmb.data.shape == (3, 1, 1, 12 * 256**2)
    assert np.isfinite(np.asarray(cmb.data)).all()
    assert dt < 120, f"IQU synthesis took {dt:.0f} s — the fast path regressed"
