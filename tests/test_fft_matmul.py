"""The matmul DFT (ops/fft.py) must be numerically interchangeable with
jnp.fft — it replaces XLA's FFT in the noise path wherever the
`matmul_fft` gate of maria_tpu/backend.py takes it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maria_tpu.ops.fft import ifft_matmul, irfft_matmul


@pytest.mark.parametrize("n", [16, 48, 384, 768, 1536, 12288, 2560])
def test_ifft_matmul_matches_numpy(n):
    rng = np.random.default_rng(n)
    z = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    a = np.asarray(ifft_matmul(jnp.asarray(z)))
    b = np.fft.ifft(z).astype(np.complex64)
    assert np.abs(a - b).max() <= 3e-6 * np.abs(b).max()


@pytest.mark.parametrize("n", [16, 48, 768, 6144, 12288])
def test_irfft_matmul_matches_numpy(n):
    rng = np.random.default_rng(n)
    S = (rng.standard_normal((3, n // 2 + 1)) + 1j * rng.standard_normal((3, n // 2 + 1))).astype(
        np.complex64
    )
    a = np.asarray(irfft_matmul(jnp.asarray(S), n))
    b = np.fft.irfft(S, n).astype(np.float32)
    assert np.abs(a - b).max() <= 3e-6 * np.abs(b).max()


def test_irfft_matmul_axis():
    rng = np.random.default_rng(0)
    S = (rng.standard_normal((5, 33, 3)) + 1j * rng.standard_normal((5, 33, 3))).astype(
        np.complex64
    )
    np.testing.assert_allclose(
        np.asarray(irfft_matmul(jnp.asarray(S), 64, axis=1)),
        np.fft.irfft(S, 64, axis=1),
        atol=1e-5,
    )


def test_noise_identical_under_matmul_fft(monkeypatch):
    """The same key must give the same noise realization (to f32 FFT
    rounding) whichever FFT backend synthesizes it."""
    from maria_tpu.noise import generate_noise_with_knee

    key = jax.random.key(7)
    kwargs = dict(shape=(24, 500), sample_rate=50.0, knee=0.7)
    monkeypatch.setenv("MARIA_TPU_FFT", "xla")
    a = np.asarray(generate_noise_with_knee(key, **kwargs))
    monkeypatch.setenv("MARIA_TPU_FFT", "matmul")
    b = np.asarray(generate_noise_with_knee(key, **kwargs))
    np.testing.assert_allclose(a, b, atol=5e-4 * a.std())
