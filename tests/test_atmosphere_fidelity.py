"""FFT-screen fidelity against the analytic Matérn statistics.

Round-4 finding: footprint-sized periodic screens cannot carry the
Matérn spectrum — every mode between the box size and the outer scale
r0 is absent, and those scales DOMINATE the aperture-smoothed structure
function (a 240 m stare box measured 4% of the analytic D^(1/2)(60 m)
and 0.7% of the field variance; a 23x deficit in sampled pwv
fluctuation). Screens are now sized >= 4 r0 per axis
(atmosphere._min_spectral_extent_cells); these oracles pin the
statistics of the screens THE SIM ACTUALLY BUILDS against the analytic
spectral integrals, so a future sizing/normalization regression cannot
hide behind a loose two-model comparison again.

Reference behavior: maria's atmosphere papers (PRD 105:042004) define
the model as Matérn(nu, r0) turbulence. (Round-5 correction: the AR
extrusion does NOT share this limitation — its conditional-Gaussian
draws carry the true covariance, so in-box D(r) is exact; the FFT
deficit was periodicity. Pinned by the test_ar_screen_* oracles below.)
"""

from __future__ import annotations

import numpy as np
import jax
import pytest
from scipy.special import j0

from maria_tpu.atmosphere.fourier import (
    field_spectral_weights_2d,
    synthesize_matern_field_2d,
)
from maria_tpu.functions import matern_spectral_density

NU, R0, RES = 1 / 3, 1e3, 10.0


def analytic_d_half(lag_m: float, beam_sigma: float) -> float:
    """sqrt(E[(F(x+r) - F(x))^2]) of the unit-variance, beam-smoothed
    Matérn field, from the isotropic spectral integral."""
    k = np.linspace(1e-5, 2.0, 100_000)
    S = matern_spectral_density(k, nu=NU, r0=R0, d=2) * k
    W = np.exp(-(beam_sigma**2) * k**2)
    return float(np.sqrt(
        2 * np.trapezoid(S * W * (1 - j0(k * lag_m)), k) / np.trapezoid(S, k)
    ))


@pytest.mark.parametrize("beam_sigma", [0.0, 42.5])
def test_screen_structure_function_matches_analytic(beam_sigma):
    cells = 512  # ~5 r0 at RES — what _min_spectral_extent_cells enforces
    W = np.asarray(field_spectral_weights_2d(
        cells, cells, RES, RES, nu=NU, r0=R0, beam_sigma=beam_sigma))
    d = {6: [], 20: []}
    var = []
    for i in range(24):
        F = np.asarray(synthesize_matern_field_2d(jax.random.key(i), W, cells, cells))
        var.append(F.var())
        for lag in d:
            d[lag].append(np.sqrt(((F[:, lag:] - F[:, :-lag]) ** 2).mean()))
    for lag, vals in d.items():
        ref = analytic_d_half(lag * RES, beam_sigma)
        got = float(np.mean(vals))
        # the 5 r0 box carries ~98% of D; ensemble-of-24 scatter is a few %
        assert abs(got / ref - 1) < 0.15, (lag, got, ref)
    # in-box variance: super-box scales (the missing ~1 - this) fold into
    # the weather-level mean-pwv draw by design
    assert 0.45 < float(np.mean(var)) < 1.05


def test_sim_screens_are_spectrally_sized():
    """The screens a real (small-footprint) sim builds must span the
    extent rule — the stare scene that exposed the bug. Small scenes
    carry the spectrum as a fine/coarse band PAIR whose coarse member
    spans it (the single big box regressed small scenes 3.7x)."""
    import maria_tpu

    sim = maria_tpu.Simulation(
        instrument="MUSTANG-2",
        plans=maria_tpu.get_plan("ten_second_zenith_stare", sample_rate=20),
        site="chajnantor", atmosphere="2d",
        atmosphere_kwargs={"method": "fourier"}, noise=False, seed=7,
    )
    obs = sim.obs_list[0]
    sim._simulate_atmosphere(obs, sim._next_key())
    screens = [s for s in obs.atmosphere.screens if s.W is not None]
    assert screens
    by_layer = {}
    for s in screens:
        by_layer.setdefault(s.h, []).append(s)
    for h, group in by_layer.items():
        bands = sorted(getattr(s, "band", "full") for s in group)
        if bands == ["full"]:
            (s,) = group
            assert s.nx * s.res >= 4.0 * R0 * 0.99, (h, s.nx, s.res)
        else:
            assert bands == ["coarse", "fine"], (h, bands)
            coarse = next(s for s in group if s.band == "coarse")
            assert coarse.nx * coarse.res >= 4.0 * R0 * 0.95, (h, coarse.nx, coarse.res)


def test_band_split_pair_matches_analytic():
    """The SUM of a fine/coarse pair sampled along a track reproduces
    the one-big-screen structure function (the pair is how small
    scenes carry the spectrum)."""
    from scipy.ndimage import map_coordinates

    from maria_tpu.atmosphere.fourier import band_split_spectral_weights_2d

    beam_sigma = 42.5
    ny_f = nx_f = 32
    res_f = RES
    L = nx_f * res_f  # 320 m footprint box
    k_c = 4 * np.pi / L
    res_c = L / 8.0
    cells_c = 112  # ~4.5 km
    W_f, W_c = band_split_spectral_weights_2d(
        ny_f, nx_f, res_f, cells_c, cells_c, res_c, k_c,
        nu=NU, r0=R0, beam_sigma=beam_sigma,
    )
    # track through the middle of both boxes (fine box centered in coarse)
    n_pts = 28
    xs_m = RES * np.arange(n_pts) + 2 * RES  # 20..290 m inside the fine box
    off = (cells_c * res_c - L) / 2
    d_by_lag = {6: [], 12: []}
    for i in range(30):
        F = np.asarray(synthesize_matern_field_2d(jax.random.key(2 * i), W_f, ny_f, nx_f))
        C = np.asarray(synthesize_matern_field_2d(jax.random.key(2 * i + 1), W_c, cells_c, cells_c))
        f_vals = map_coordinates(F, [np.full(n_pts, ny_f / 2), xs_m / res_f], order=1)
        c_vals = map_coordinates(
            C, [np.full(n_pts, cells_c / 2), (xs_m + off) / res_c], order=1)
        v = f_vals + c_vals
        for lag in d_by_lag:
            d_by_lag[lag].append(np.sqrt(((v[lag:] - v[:-lag]) ** 2).mean()))
    for lag, vals in d_by_lag.items():
        ref = analytic_d_half(lag * RES, beam_sigma)
        got = float(np.mean(vals))
        assert abs(got / ref - 1) < 0.25, (lag, got, ref)


def test_sim_3d_groups_are_spectrally_sized():
    import maria_tpu

    sim = maria_tpu.Simulation(
        instrument="MUSTANG-2",
        plans=maria_tpu.get_plan("ten_second_zenith_stare", sample_rate=20),
        site="chajnantor", atmosphere="3d", noise=False, seed=7,
    )
    obs = sim.obs_list[0]
    sim._simulate_atmosphere(obs, sim._next_key())
    for g in getattr(obs.atmosphere, "groups", []):
        assert g.nx * g.res >= 4.0 * R0 * 0.99
        assert g.ny * g.res >= 4.0 * R0 * 0.99


def test_layered_3d_statistics_match_analytic():
    """Each layer of the vertically-correlated 3-D stack is a
    restriction of the 3-D Matérn field — unit variance and the 2-D
    structure function (up to grid truncation of sub-resolution scales,
    which real scenes' beam smoothing absorbs)."""
    from maria_tpu.atmosphere.fourier import (
        layered_field_spectral_weights,
        synthesize_layered_matern_2d,
    )

    heights = np.array([250.0, 750.0, 1250.0, 2500.0, 4000.0])
    cells, res = 256, 20.0
    W, Mc, Ms, _ = layered_field_spectral_weights(
        cells, cells, res, res, heights, nu=NU, r0=R0)
    var, d = [], []
    for i in range(10):
        F = np.asarray(synthesize_layered_matern_2d(
            jax.random.key(i), W, Mc, Ms, None, cells, cells))
        var.append(F.var(axis=(1, 2)))
        d.append(np.sqrt(((F[:, :, 3:] - F[:, :, :-3]) ** 2).mean(axis=(1, 2))))
    var = np.mean(var, axis=0)
    d = np.mean(d, axis=0)
    assert np.all((var > 0.75) & (var < 1.3)), var
    ref = analytic_d_half(3 * res, 0.0)
    # ~10% deficit is the res-20m grid's truncation of sub-resolution
    # scales (the continuum integral runs to 3 m scales)
    assert np.all(np.abs(d / ref - 1) < 0.2), (d, ref)


def _ar_structure_ratios(ny, nx, lags, n_real, seed0=0):
    from maria_tpu.atmosphere.process import AutoregressiveProcess

    cross = np.stack([RES * np.arange(ny), np.full(ny, 500.0)], axis=-1)
    proc = AutoregressiveProcess(
        cross_section=cross, extrusion=RES * np.arange(nx),
        callback_kwargs={"nu": NU, "r0": R0},
    )
    fields = [np.asarray(proc.run(jax.random.key(seed0 + i))) for i in range(n_real)]
    out = {}
    for lag in lags:
        d = np.mean([np.sqrt(((F[lag:, :] - F[:-lag, :]) ** 2).mean()) for F in fields])
        out[lag] = d / analytic_d_half(lag * RES, 0.0)
    dy = np.mean([np.sqrt(((F[:, 6:] - F[:, :-6]) ** 2).mean()) for F in fields])
    out["y6"] = dy / analytic_d_half(6 * RES, 0.0)
    return out


def test_ar_screen_structure_function_matches_analytic():
    """The AR path's in-box statistics are EXACT-covariance, not the
    FFT box's band-limited ones: the conditional-Gaussian extrusion
    (process.py) draws with the true Matérn covariance between its grid
    points, so D(r) matches the analytic spectral integral on a
    footprint-sized grid — the round-4 'AR shares the footprint-grid
    deficit' parity note was wrong (the FFT deficit was PERIODICITY,
    which the AR never had). Measured here at >=90% recovery
    (docs/design.md, "The 3-D atmosphere's screens").

    Reference behavior: maria/atmosphere/process.py:19-209 — we beat
    its approximation class (finite lookback) rather than match it."""
    # short lags on a footprint grid: per-realization spatial means of a
    # correlated field scatter ~10% at 8 realizations, so the bound is
    # recovery-class (>=88%), not exactness
    ratios = _ar_structure_ratios(ny=16, nx=128, lags=(6, 16), n_real=8)
    for key, r in ratios.items():
        assert abs(r - 1) < 0.12, (key, r)


@pytest.mark.slow
def test_ar_screen_long_extrusion_structure_function():
    """Decimated-lookback stress: a 5 r0 extrusion must still recover
    the structure function at multi-r0 lags (the exponentially
    decimated conditioning truncates history; measured 94-102%)."""
    ratios = _ar_structure_ratios(ny=16, nx=512, lags=(64, 128, 256), n_real=8)
    for key, r in ratios.items():
        assert abs(r - 1) < 0.10, (key, r)
