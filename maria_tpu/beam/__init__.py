"""Gaussian-optics beam model (reference: maria/beam/__init__.py:9-79)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import c


def compute_angular_fwhm(fwhm_0, z=np.inf, n=1.0, nu=None, l=None):  # noqa: E741
    """Angular FWHM of a Gaussian beam at distance z.

    Valid from near field to far field via the Rayleigh range; `fwhm_0` is
    the aperture (primary) diameter, `nu` in Hz or `l` (wavelength) in m.
    """
    if nu is None and l is None:
        raise ValueError("You must supply either a frequency 'nu' or wavelength 'l'.")
    w_0 = fwhm_0 / 2
    z_r = np.pi * w_0**2 * n / (l if l is not None else c / nu)
    z = np.asarray(z, dtype=float)
    with np.errstate(divide="ignore"):
        inv_z = np.where(np.isinf(z), 0.0, 1.0 / np.where(np.isinf(z), 1.0, z))
    return 2 * w_0 * np.sqrt(inv_z**2 + 1 / z_r**2)


def compute_physical_fwhm(fwhm_0, z=np.inf, n=1.0, nu=None, l=None):  # noqa: E741
    return z * compute_angular_fwhm(fwhm_0=fwhm_0, z=z, n=n, nu=nu, l=l)


def construct_beam_filter(fwhm, res, beam_profile=None, buffer=1):
    """A normalized beam kernel image (reference beam/__init__.py:32)."""
    if beam_profile is None:

        def beam_profile(r, r0):  # a soft-edged top hat
            return np.exp(-((r / r0) ** 16))

    filter_width = buffer * fwhm
    n_side = max(int(filter_width / res), 3)
    side = np.linspace(-filter_width / 2, filter_width / 2, n_side)
    X, Y = np.meshgrid(side, side, indexing="ij")
    F = beam_profile(np.sqrt(X**2 + Y**2), fwhm / 2)
    return F / F.sum()


def gaussian_beam_fft_filter(shape, res_y, res_x, fwhm):
    """Fourier transfer function of a Gaussian beam on a 2-D grid.

    The device counterpart of the reference's separable image-space
    convolution (beam/__init__.py:56): beam smoothing becomes one
    multiply in Fourier space, fused with any other spectral work.
    """
    sigma = fwhm / (2 * np.sqrt(2 * np.log(2)))
    ky = jnp.fft.fftfreq(shape[0], d=res_y) * 2 * jnp.pi
    kx = jnp.fft.rfftfreq(shape[1], d=res_x) * 2 * jnp.pi
    return jnp.exp(-0.5 * sigma**2 * (ky[:, None] ** 2 + kx[None, :] ** 2))


def separably_filter_2d(data, F, tol=1e-2):
    """SVD-separable 2-D convolution with early truncation
    (reference beam/__init__.py:56-79); host-side fallback."""
    import scipy as sp

    if F.ndim != 2:
        raise ValueError("'F' must be two-dimensional.")
    u, s, v = np.linalg.svd(F)
    effective = np.zeros_like(F)
    filtered = np.zeros_like(np.asarray(data, dtype=float))
    for m in range(len(s)):
        effective += s[m] * u[:, m : m + 1] @ v[m : m + 1]
        filtered += s[m] * sp.ndimage.convolve1d(
            sp.ndimage.convolve1d(data, u[:, m], axis=-2), v[m], axis=-1
        )
        if np.abs(F - effective).mean() < tol:
            break
    return filtered
