"""Matmul-formulated DFTs.

Where a platform's FFT runs far off its memory bound for the large
batched 1-D transforms the noise synthesis needs, a Cooley-Tukey
two-factor split turns the same transform into two small dense matmuls
plus a twiddle multiply — a few hundred GFLOP of matrix work — with the
real inverse built on a half-size complex iDFT via the standard
even/odd packing. Exact to f32 (tested vs jnp.fft.irfft).

These are drop-in only for sizes whose factors stay small; the
`good_fft_size` grid (odd part <= 9) always factors well. Which platform
takes them is the `matmul_fft` gate of maria_tpu/backend.py.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ifft_matmul", "irfft_matmul", "use_matmul_fft"]

# single-matmul threshold: an (N, N) DFT matrix up to this size is
# cheaper than the two-stage split (constants stay < 8 MB)
_SINGLE_MAX = 512


def use_matmul_fft() -> bool:
    """Whether the matmul DFT should replace jnp.fft on this platform
    (the `matmul_fft` gate of maria_tpu/backend.py). Override with
    MARIA_TPU_FFT=matmul|xla."""
    import os

    from ..backend import use

    mode = os.environ.get("MARIA_TPU_FFT", "").lower()
    if mode == "matmul":
        return True
    if mode == "xla":
        return False
    return use("matmul_fft")


def _best_split(n: int) -> tuple:
    """Factor n = n1 * n2 with the pair as square as possible (both
    matmul contractions then run near the MXU's 128-deep sweet spot for
    the good_fft_size grid)."""
    best = None
    for n1 in range(2, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = (n // n1, n1)
    if best is None:
        return None
    return best


@lru_cache(maxsize=64)
def _idft_constants(n: int):
    """Host-built DFT matrices/twiddles for the inverse c2c transform."""
    if n <= _SINGLE_MAX or _best_split(n) is None:
        k = np.arange(n)
        E = np.exp(2j * np.pi * np.outer(k, k) / n) / n
        return ("single", E.astype(np.complex64))
    n1, n2 = _best_split(n)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    E1 = np.exp(2j * np.pi * np.outer(k1, k1) / n1).astype(np.complex64)
    E2 = np.exp(2j * np.pi * np.outer(k2, k2) / n2).astype(np.complex64)
    # twiddle carries the 1/n normalization
    T = (np.exp(2j * np.pi * np.outer(k1, k2) / n) / n).astype(np.complex64)
    return ("split", n1, n2, E1, E2, T)


def ifft_matmul(z, axis: int = -1):
    """Inverse c2c DFT along `axis` (numpy ifft convention, 1/n), as
    MXU matmuls. z: complex64."""
    z = jnp.asarray(z)
    axis = axis % z.ndim
    if axis != z.ndim - 1:
        z = jnp.moveaxis(z, axis, -1)
    n = z.shape[-1]
    consts = _idft_constants(n)
    P = jax.lax.Precision.HIGHEST
    if consts[0] == "single":
        out = jnp.einsum("nk,...k->...n", jnp.asarray(consts[1]), z, precision=P)
    else:
        _, n1, n2, E1, E2, T = consts
        # index split k = k2 + n2*k1 -> C-order (n1, n2) matrix
        zr = z.reshape(*z.shape[:-1], n1, n2)
        A = jnp.einsum("nk,...kc->...nc", jnp.asarray(E1), zr, precision=P)
        B = A * jnp.asarray(T)
        # output n = n1 + n1_total*n2 -> C-order (n2, n1) matrix
        X = jnp.einsum("...nc,mc->...mn", B, jnp.asarray(E2), precision=P)
        out = X.reshape(*z.shape[:-1], n)
    if axis != out.ndim - 1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def irfft_matmul(S, n: int = None, axis: int = -1):
    """Real inverse DFT from the half-spectrum (numpy irfft convention)
    via ONE half-size complex iDFT: the even/odd packing x[2m] + i
    x[2m+1] = ifft(E + iO) with E/O recovered from the Hermitian
    symmetry. Requires even n (good_fft_size grids are always even)."""
    S = jnp.asarray(S)
    axis = axis % S.ndim
    if axis != S.ndim - 1:
        S = jnp.moveaxis(S, axis, -1)
    n = n if n is not None else 2 * (S.shape[-1] - 1)
    if n % 2:
        raise ValueError("irfft_matmul requires even n")
    m = n // 2
    if S.shape[-1] < m + 1:
        raise ValueError(f"half-spectrum too short for n={n}")
    # numpy's c2r drops the imaginary parts of the self-conjugate DC and
    # Nyquist bins; match that convention exactly
    real_dc = jnp.real(S[..., :1]).astype(S.dtype)
    real_ny = jnp.real(S[..., m : m + 1]).astype(S.dtype)
    S = jnp.concatenate([real_dc, S[..., 1:m], real_ny], axis=-1)
    Sk = S[..., :m]
    Srev = S[..., 1 : m + 1][..., ::-1]  # S[m - k], k = 0..m-1
    E = 0.5 * (Sk + jnp.conj(Srev))
    W = jnp.asarray(np.exp(2j * np.pi * np.arange(m) / n).astype(np.complex64))
    O = 0.5 * W * (Sk - jnp.conj(Srev))
    y = ifft_matmul(E + 1j * O)
    out = jnp.stack([jnp.real(y), jnp.imag(y)], axis=-1).reshape(*S.shape[:-1], n)
    if axis != out.ndim - 1:
        out = jnp.moveaxis(out, -1, axis)
    return out
