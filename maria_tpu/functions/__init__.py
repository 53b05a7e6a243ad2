"""Covariance kernels and generic math used across the framework.

The Matérn family here matches the reference's kernels (reference
maria/functions/__init__.py:15-74). The device twist: `MaternInterpolator`
precomputes the log-log blended table *once* on the host and evaluates it
on device with a pure-jnp interpolation, so covariance evaluation can run
inside jit over arbitrarily large distance arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import scipy as sp

from .radiometry import (  # noqa: F401
    inverse_planck_spectrum,
    inverse_rayleigh_jeans_spectrum,
    planck_spectrum,
    rayleigh_jeans_spectrum,
)

__all__ = [
    "sigmoid",
    "inverse_sigmoid",
    "matern",
    "normalized_matern",
    "matern_three_halves",
    "matern_five_halves",
    "approximate_normalized_matern",
    "MaternInterpolator",
    "matern_spectral_density",
]


def sigmoid(x):
    return 1 / (1 + np.exp(-x))


def inverse_sigmoid(y):
    return -np.log(1 / y - 1)


def matern(r, r0, nu):
    """Matérn covariance with outer scale r0."""
    return normalized_matern(r / r0, nu)


def matern_three_halves(r):
    return (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)


def matern_five_halves(r):
    return (1 + np.sqrt(3) * r + (5.0 / 3.0) * r**2) * np.exp(-np.sqrt(5) * r)


def normalized_matern(r, nu):
    """Unit-variance Matérn covariance (host only; uses Bessel K)."""
    arg = np.sqrt(2 * nu) * np.asarray(r, dtype=float) + 1e-16
    return 2 ** (1 - nu) / sp.special.gamma(nu) * sp.special.kv(nu, arg) * arg**nu


def _matern_log_tables(nu: float, n_test_points: int = 1024):
    """Precompute the blended log-log interpolation tables.

    The blend of structure-function and covariance interpolation follows the
    reference's precision trick (maria/functions/__init__.py:42-74): the
    structure function 1-C(r) is interpolated in log-log space at small r
    (where C ≈ 1 and direct interpolation of C loses precision) and the
    covariance at large r, crossfaded at r_eff ≈ 1.
    """
    r_eff_min, r_eff_max = 1e-6, 1e3
    r_samples = np.geomspace(r_eff_min, r_eff_max, n_test_points)
    cov = normalized_matern(r_samples, nu=nu)
    log_r = np.log(r_samples)
    log_sf = np.log(np.clip(1 - cov, 1e-300, None))
    log_cov = np.log(np.clip(cov, 1e-300, None))
    return log_r, log_sf, log_cov


def approximate_normalized_matern(r, nu=1 / 3, r0=1e0, n_test_points=1024):
    """Fast approximate unit-variance Matérn, usable over huge matrices.

    Host (numpy) version; parity with the reference implementation.
    """
    log_r_tab, log_sf_tab, log_cov_tab = _matern_log_tables(nu, n_test_points)

    r = np.asarray(r, dtype=float)
    r_eff = np.abs(r) / r0
    r_eff_safe = np.clip(np.atleast_1d(r_eff), 1e-6, None)

    log_r = np.log(r_eff_safe)
    sf = np.exp(np.interp(log_r, log_r_tab, log_sf_tab))
    cov = np.exp(np.interp(log_r, log_r_tab, log_cov_tab))

    t = 1 / (1 + r_eff_safe**2)
    res = np.where(r_eff_safe < 1e3, t * (1 - sf) + (1 - t) * cov, 0.0)
    return res.reshape(np.shape(r)) if np.shape(r) else res[0]


class MaternInterpolator:
    """Device-side approximate Matérn kernel.

    Precomputes the blended log-log tables on host; `__call__` is pure jnp
    and safe to use inside jit (static tables are closed over as constants).
    """

    def __init__(self, nu: float, r0: float = 1.0, n_test_points: int = 1024):
        self.nu = float(nu)
        self.r0 = float(r0)
        log_r, log_sf, log_cov = _matern_log_tables(nu, n_test_points)
        self._log_r = jnp.asarray(log_r)
        self._log_sf = jnp.asarray(log_sf)
        self._log_cov = jnp.asarray(log_cov)

    def __call__(self, r):
        r_eff = jnp.clip(jnp.abs(r) / self.r0, 1e-6, None)
        log_r = jnp.log(r_eff)
        sf = jnp.exp(jnp.interp(log_r, self._log_r, self._log_sf))
        cov = jnp.exp(jnp.interp(log_r, self._log_r, self._log_cov))
        t = 1 / (1 + r_eff**2)
        return jnp.where(r_eff < 1e3, t * (1 - sf) + (1 - t) * cov, 0.0)


def matern_spectral_density(k, nu: float, r0: float, d: int):
    """Unnormalized spectral density of the unit-variance Matérn kernel in d dims.

    With the reference's convention C(r) ∝ K_nu(sqrt(2 nu) r / r0), the
    correlation length is l = r0 / sqrt(2 nu) and the isotropic spectral
    density is S(k) ∝ (1/l^2 + k^2)^-(nu + d/2) (Whittle-Matérn). Used by
    the FFT turbulence synthesis path; the overall normalization is fixed
    numerically so the synthesized field has unit variance.

    `k` is angular wavenumber (rad / meter); works with numpy or jnp.
    """
    inv_l2 = 2 * nu / r0**2
    return (inv_l2 + k**2) ** -(nu + d / 2)
