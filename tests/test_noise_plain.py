"""The plain per-band noise path (`generate_noise_with_knee`: one
spectral draw, then an inverse real FFT) against numpy's irfft of the
same draw, on both sides of the `matmul_fft` gate."""

import jax
import numpy as np
import pytest

from maria_tpu.atmosphere.fourier import good_fft_size
from maria_tpu.noise import _pink_weights_np, _spectral_white, generate_noise_with_knee


@pytest.mark.parametrize("fft", ["xla", "matmul"])
@pytest.mark.parametrize("n,n_fft", [(3000, 3072), (500, 512), (3072, 3072)])
def test_plain_noise_matches_numpy_irfft(n, n_fft, fft, monkeypatch):
    """For the SAME draw, the synthesized noise equals
    numpy.fft.irfft(weights * spectrum)[:n] (truncation included)."""
    monkeypatch.setenv("MARIA_TPU_FFT", fft)
    assert good_fft_size(n) == n_fft
    key = jax.random.key(7)
    n_det, rate, knee = 5, 50.0, 1.0
    with jax.default_matmul_precision("highest"):
        x = np.asarray(generate_noise_with_knee(key, (n_det, n), sample_rate=rate, knee=knee))
    _white, key_pink, _modes = jax.random.split(key, 3)
    spectrum = np.asarray(_spectral_white(key_pink, (n_det,), n_fft)).astype(np.complex128)
    w = np.sqrt(rate + _pink_weights_np(n_fft, rate, knee, 1.0) ** 2)
    ref = np.fft.irfft(w * spectrum, n=n_fft)[:, :n]
    assert x.shape == (n_det, n)
    np.testing.assert_allclose(x, ref, atol=2e-4 * ref.std())
