"""Signal-processing tools for TOD post-processing.

SVD decomposition, B-spline bases and frequency-domain filters
(reference: maria/utils/signal/__init__.py and signal/filters.py). The
filters here are FFT brick-wall-with-rolloff transfer functions applied
in jnp — an accelerator-friendly equivalent of the reference's scipy Bessel
IIR filtfilt (same passbands, linear phase by construction).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import scipy as sp

__all__ = [
    "decompose",
    "detrend",
    "bspline_basis",
    "bspline_knots",
    "bspline_basis_from_knots",
    "bspline_basis_domain",
    "fit_bspline",
    "cross_basis",
    "fast_downsample",
    "remove_slope",
    "grouper",
    "lowpass",
    "highpass",
    "bandpass",
    "bessel_lowpass",
    "bessel_highpass",
]


def decompose(data, k: int = None, downsample_rate: int = 1, mode: str = "uv"):
    """Truncated SVD of (n_det, n_time) data (reference signal/__init__.py:59).

    Returns (a, b) with data ≈ a @ b; `a` is (n_det, k) mode mixing,
    `b` is (k, n_time) mode time series.
    """
    data = np.asarray(data)
    u, s, vh = np.linalg.svd(data[:, ::downsample_rate], full_matrices=False)
    k = k or len(s)
    a = u[:, :k] * s[:k]
    if downsample_rate > 1:
        b = np.linalg.lstsq(a, data, rcond=None)[0]
    else:
        b = vh[:k]
    return a, b


def detrend(data, order: int = 1):
    """Remove a least-squares polynomial along the last axis."""
    data = np.asarray(data)
    n = data.shape[-1]
    x = np.linspace(-1, 1, n)
    V = np.polynomial.polynomial.polyvander(x, order)
    coeffs, *_ = np.linalg.lstsq(V, data.reshape(-1, n).T, rcond=None)
    return (data.reshape(-1, n) - (V @ coeffs).T).reshape(data.shape)


def bspline_basis(n: int, spacing: int = None, n_knots: int = None, order: int = 3):
    """Cubic B-spline basis over n samples (reference signal/__init__.py:107)."""
    if spacing is None and n_knots is None:
        raise ValueError("supply either 'spacing' (in samples) or 'n_knots'")
    n_knots = n_knots or max(int(n / spacing) + 1, 2)
    t = np.linspace(0, n - 1, n_knots)
    t = np.r_[[t[0]] * order, t, [t[-1]] * order]
    x = np.arange(n)
    k = len(t) - order - 1
    B = np.stack(
        [sp.interpolate.BSpline.basis_element(t[i : i + order + 2], extrapolate=False)(x) for i in range(k)],
        axis=0,
    )
    return np.nan_to_num(B)


def bspline_knots(t, spacing, order: int = 3):
    """Uniform knot vector straddling the domain of t, padded by `order`
    on each side (reference signal/__init__.py:91-105)."""
    t = np.asarray(t, dtype=float)
    tmin, tmax = t.min(), t.max()
    n_bins = max(int((tmax - tmin) // spacing), 1)
    k = spacing * np.arange(n_bins, dtype=float)
    k += (tmax + tmin) / 2 - k.mean()
    return np.r_[
        k[0] + spacing * np.arange(-order - 1, 0),
        k,
        k[-1] + spacing * np.arange(1, order + 2),
    ]


def bspline_basis_from_knots(t, k, order: int = 3):
    """(n_basis, len(t)) B-spline basis by Cox–de Boor recursion over a
    given knot vector (reference signal/__init__.py:108-120)."""
    t = np.asarray(t, dtype=float)
    k = np.asarray(k, dtype=float)
    n_basis = len(k) - order - 1
    B = np.zeros((len(k) + 1, order + 1, len(t)))
    B[np.digitize(t, k) - 1, 0, np.arange(len(t))] = 1
    for p in range(1, order + 1):
        for i in range(len(k) - p - 1):
            left = (t - k[i]) / (k[i + p] - k[i])
            right = (k[i + p + 1] - t) / (k[i + p + 1] - k[i + 1])
            B[i, p] = B[i, p - 1] * left + B[i + 1, p - 1] * right
    return B[:n_basis, -1]


def bspline_basis_domain(t, spacing, order: int = 3):
    """Reference-signature basis: evaluated at sample positions t with a
    knot spacing in the same units (reference signal/__init__.py:123-125)."""
    return bspline_basis_from_knots(t, bspline_knots(t, spacing, order), order)


def fit_bspline(y, x, spacing, order: int = 3):
    """Least-squares B-spline fit of y(x) (reference
    signal/__init__.py:128-131); returns the fitted curve."""
    B = bspline_basis_domain(np.asarray(x, dtype=float), spacing=spacing, order=order)
    keep = B.sum(axis=-1) > 0
    B = B[keep]
    coeffs, *_ = np.linalg.lstsq(B.T, np.asarray(y, dtype=float).T, rcond=None)
    return (coeffs.T @ B).reshape(np.shape(y))


def cross_basis(X: list, spacing: list, order: list):
    """Tensor-product basis over several coordinates, pruning empty
    products (reference signal/__init__.py:134-142)."""
    basis = np.ones((1, 1))
    for dim, x in enumerate(X):
        x_basis = bspline_basis_domain(np.asarray(x, dtype=float), spacing[dim], order[dim])
        basis = (x_basis[:, None] * basis).reshape(-1, len(np.asarray(x)))
        basis = basis[basis.sum(axis=-1) > 0]
    return basis


def fast_downsample(data, r: int = 1):
    """Block-mean downsample via one cumsum pass (reference
    signal/__init__.py:16-19)."""
    data = np.asarray(data)
    *in_shape, n = data.shape
    cs = np.cumsum(np.atleast_2d(data), axis=-1)
    return ((cs[..., r::r] - cs[..., :-r:r]) / r).reshape(*in_shape, -1)


def remove_slope(data):
    """Subtract the line through each row's endpoints (reference
    signal/__init__.py:152-153)."""
    data = np.asarray(data)
    return data - np.moveaxis(
        np.linspace(data[..., 0], data[..., -1], data.shape[-1]), 0, -1
    )


def grouper(iterable, min_length: int = 1, max_length: float = np.inf, overlap: bool = False):
    """Yield (start, stop) half-open index pairs of True runs, splitting
    runs longer than max_length (reference signal/__init__.py:156-175).
    For a vectorized variant see tod.signal.contiguous_runs."""
    start = np.inf
    prev_value = False
    index = -1
    for index, this_value in enumerate(iterable):
        if this_value:
            if not prev_value:
                start = index
            elif index - start >= max_length:
                yield (start, index)
                start = index
        elif prev_value and index - start >= min_length:
            yield (start, index)
        prev_value = this_value
    if prev_value and index + 1 - start >= min_length:
        yield (start, index + 1)


def bessel_lowpass(data, fc, sample_rate, order: int = 1, axis: int = -1):
    """Causal Bessel IIR low-pass, matching the reference's filter family
    exactly (reference signal/filters.py:49-57). The FFT filters below
    are the accelerator-friendly default; this is for users comparing against
    reference pipelines bit-for-bit."""
    sos = sp.signal.bessel(2 * (order + 1), 2 * fc / sample_rate, analog=False, btype="low", output="sos")
    return sp.signal.sosfilt(sos, data, axis=axis)


def bessel_highpass(data, fc, sample_rate, order: int = 1, axis: int = -1):
    """Causal Bessel IIR high-pass (reference signal/filters.py:60-68)."""
    sos = sp.signal.bessel(2 * (order + 1), 2 * fc / sample_rate, analog=False, btype="high", output="sos")
    return sp.signal.sosfilt(sos, data, axis=axis)


def _fft_filter(data, sample_rate, transfer):
    data = jnp.asarray(data)
    n = data.shape[-1]
    f = jnp.fft.rfftfreq(n, d=1 / sample_rate)
    return jnp.fft.irfft(jnp.fft.rfft(data, axis=-1) * transfer(f), n=n, axis=-1)


def _rolloff(f, cutoff, order):
    # |H|² of an order-n Butterworth; applied once → linear-phase FFT filter
    return 1.0 / jnp.sqrt(1.0 + (f / cutoff) ** (2 * order))


def lowpass(data, cutoff, sample_rate, order: int = 4):
    return _fft_filter(data, sample_rate, lambda f: _rolloff(f, cutoff, order))


def highpass(data, cutoff, sample_rate, order: int = 4):
    return _fft_filter(
        data, sample_rate, lambda f: 1.0 - _rolloff(f, cutoff, order)
    )


def bandpass(data, f_lower, f_upper, sample_rate, order: int = 4):
    return _fft_filter(
        data,
        sample_rate,
        lambda f: (1.0 - _rolloff(f, f_lower, order)) * _rolloff(f, f_upper, order),
    )
