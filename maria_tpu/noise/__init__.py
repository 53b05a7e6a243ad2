"""Detector-noise synthesis (reference: maria/noise/generation.py:11-61).

White + 1/f^beta "pink" noise with a knee, optionally with a spatially
correlated component projected through a low-rank Matérn focal-plane
basis. Pure jnp: the pink weighting is one rfft/irfft pair that fuses
with the rest of the simulation program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["generate_noise_with_knee", "generate_2d_fourier_noise"]

DEFAULT_NOISE_SIM_KWARGS = {
    "correlated_noise_proportion": 0.5,
    "correlated_noise_spatial_scale": 1.0,
}


def _pink_weights_np(n: int, sample_rate: float, knee: float, beta: float):
    f = np.fft.rfftfreq(n, d=1 / sample_rate)
    with np.errstate(divide="ignore"):
        ps = np.where(f != 0, (knee / 2) / np.abs(f) ** beta, 0.0)
    return np.sqrt(2 * sample_rate * ps)


def _pink_weights(n: int, sample_rate: float, knee: float, beta: float):
    return jnp.asarray(_pink_weights_np(n, sample_rate, knee, beta), dtype=jnp.float32)


def _spectral_white_scale_np(n_fft: int):
    """Per-bin amplitude of the spectral-white draw (see _spectral_white)."""
    n_f = n_fft // 2 + 1
    scale = np.full(n_f, np.sqrt(n_fft / 2))
    scale[0] = np.sqrt(n_fft)
    if n_fft % 2 == 0:
        scale[-1] = np.sqrt(n_fft)
    return scale


def _spectral_white(key, shape, n_fft: int):
    """Complex spectrum distributed as rfft(N(0,1)^n_fft) — drawn
    directly in the frequency domain, skipping the forward FFT (the
    rfft of white noise IS complex white noise). Var(Re X_k) =
    Var(Im X_k) = n/2 for interior bins; DC and Nyquist are real with
    variance n."""
    n_f = n_fft // 2 + 1
    z = jax.random.normal(key, (*shape, n_f, 2), dtype=jnp.float32)
    re, im = z[..., 0], z[..., 1]
    scale = jnp.full(n_f, np.sqrt(n_fft / 2), dtype=jnp.float32)
    scale = scale.at[0].set(np.sqrt(n_fft))
    if n_fft % 2 == 0:
        scale = scale.at[-1].set(np.sqrt(n_fft))
    edge = jnp.zeros(n_f, dtype=jnp.float32).at[1 : n_f - (1 - n_fft % 2)].set(1.0)
    return scale * (re + 1j * im * edge)


def generate_noise_with_knee(
    key,
    shape: tuple,
    sample_rate: float = 1.0,
    knee: float = 0.0,
    beta: float = 1.0,
    basis=None,
    corr_prop: float = 0.0,
):
    """Unit-NEP noise of the given shape (..., n_time).

    The white component has variance sample_rate per sample (so that
    multiplying by an NEP in W√s gives the right power spectral density);
    the pink component adds (knee/2)/f^beta to the one-sided PSD.
    """
    n = shape[-1]
    key_white, key_pink, key_modes = jax.random.split(key, 3)
    if knee <= 0:
        return jnp.sqrt(sample_rate) * jax.random.normal(key_white, shape, dtype=jnp.float32)

    # synthesize on a fast FFT length and truncate: the series is
    # stationary, so a slice has the same PSD. The WHITE component fuses
    # into the same spectral draw (white + independent pink filtered by
    # w has the spectrum fs + w^2 — one irfft, no separate (..., n_time)
    # normal, ~45% fewer PRNG bits). Spectra are drawn directly in the
    # frequency domain (the rfft of white noise IS complex white noise).
    from ..atmosphere.fourier import good_fft_size
    from ..ops.fft import irfft_matmul, use_matmul_fft

    # the platform table (maria_tpu/backend.py) picks the matmul DFT or
    # jnp.fft
    irfft = irfft_matmul if use_matmul_fft() else (
        lambda z, n, axis=-1: jnp.fft.irfft(z, n=n, axis=axis)
    )

    n_fft = good_fft_size(n)
    weights = _pink_weights(n_fft, sample_rate, knee, beta)
    cp = corr_prop if basis is not None else 0.0

    w_det = jnp.sqrt(sample_rate + (1.0 - cp) * weights**2)
    noise = irfft(
        w_det * _spectral_white(key_pink, shape[:-1], n_fft), n_fft, axis=-1
    )[..., :n]
    if cp > 0:
        basis = jnp.asarray(basis, dtype=jnp.float32)
        k = basis.shape[-1]
        mode_noise = irfft(
            weights * _spectral_white(key_modes, (k,), n_fft), n_fft, axis=-1
        )[..., :n]
        noise = noise + jnp.sqrt(corr_prop) * basis @ mode_noise
    return noise


def generate_2d_fourier_noise(
    key, nx: int = 1024, ny: int = 1024, k0: float = 5.0, beta: float = 8 / 3
):
    """Standardized 2-D field with an isotropic (k0^2 + |k|^2)^-(beta+1)/2
    power-law spectrum (reference: maria/noise/generation.py:54 — there a
    numpy helper; here key-threaded jnp so it composes under jit)."""
    kx = jnp.fft.fftfreq(nx, d=1 / nx)
    ky = jnp.fft.fftfreq(ny, d=1 / ny)
    P = jnp.sqrt(k0**2 + kx[None, :] ** 2 + ky[:, None] ** 2) ** (-beta - 1)
    white = jax.random.normal(key, (ny, nx), dtype=jnp.float32)
    F = jnp.fft.fft2(jnp.sqrt(P) * jnp.fft.ifft2(white)).real
    return (F - F.mean()) / F.std()
