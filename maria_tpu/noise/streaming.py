"""Streaming 1/f noise for bounded-memory long observations.

The batch generator (noise/__init__.py) synthesizes pink noise with one
FFT over the whole observation — O(n_t) memory, and a chunked FFT would
lose all power below 1/chunk. This module streams the same spectrum at
O(1) state per detector: K AR(1) processes with log-spaced poles,
driven by ONE shared innovation stream and summed with signed
amplitudes — a K-pole rational filter whose magnitude is fit to the
1/f^beta target (alternating phase-fixing least squares). Sharing the
innovation costs nothing in fit quality versus independent-stream
cascades at equal K but needs K× fewer random bits per block — at
AtLAST scale the normals would otherwise dominate the streaming PRNG
budget. The recursion over a block is one `associative_scan` —
parallel-prefix, so the time axis still vectorizes on device.

Chunk-invariance: a block's output depends only on (carried state,
block key), so any grouping of blocks gives identical streams. The
spectrum matches the FFT path's above ~1/T_ref and flattens below it
(stationary, finite variance) — choose T_ref at least the observation
length (tested against the batch generator's periodogram). Structural
cap: every rational filter's PSD has zero slope at Nyquist, so the fit
cannot track 1/f through the last fraction of an octave — the deviation
there reaches ~13% of the PINK part, ~4% of the white+pink total at
MUSTANG-like knees, and shrinks with knee/Nyquist (asserted in
tests/test_streaming_exec.py::test_cascade_fit_quality).

Reference behavior: maria/noise/generation.py:11 (white + pink with a
knee); the reference synthesizes eagerly over the full observation.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["PinkCascade", "StreamingBandNoise"]


def _fit_cascade(sample_rate: float, knee: float, beta: float, T_ref: float, poles_per_decade: float):
    """Fit poles p_k and SIGNED amplitudes a_k so that the rational
    filter R(w) = sum_k a_k / (1 - p_k e^{-iw}) — all poles driven by one
    shared innovation stream — has |R|^2 matching the batch pink filter's
    squared magnitude 2 * fs * (knee/2) / f^beta on a log grid.

    Magnitude-only fitting is non-convex; the classic fix is alternating
    phase-fixing: freeze the phase of the current R, solve the now-linear
    complex least squares for a, repeat. Initialized from the incoherent
    NNLS solution (which is also the fallback if the iteration ever
    degrades it)."""
    import scipy.optimize

    # fit one decade below f_min so [f_min, fs/2] sits in the interior of
    # the fit (edge scalloping lands below the band anyone observes)
    f_min = 1.0 / T_ref
    f_lo = f_min / 10
    f_max = sample_rate / 2
    n_decades = np.log10(f_max / f_lo)
    K = max(3, int(np.ceil(n_decades * poles_per_decade)) + 1)
    f_poles = np.geomspace(f_lo / 2, f_max, K)
    p = np.exp(-2 * np.pi * f_poles / sample_rate)

    f_grid = np.geomspace(f_lo, f_max * 0.999, 32 * K)
    w = 2 * np.pi * f_grid / sample_rate
    H = 1.0 / (1 - p[None, :] * np.exp(-1j * w[:, None]))  # (n_grid, K)
    target = 2 * sample_rate * (knee / 2) / f_grid**beta
    s = np.sqrt(target)
    Wt = 1.0 / s  # relative error metric, equal weight per octave

    def pink_err(a):
        return np.abs(np.log(np.abs(H @ a) ** 2 / target)).max()

    # init: incoherent NNLS on the per-pole power spectra
    G = np.abs(H) ** 2
    A = (G / target[:, None])
    col = np.linalg.norm(A, axis=0)  # unit columns keep the solve well-conditioned
    res = scipy.optimize.lsq_linear(A / col, np.ones_like(target), bounds=(0.0, np.inf))
    a = np.sqrt(np.maximum(res.x, 0.0) / col)
    best_a, best_err = a.copy(), pink_err(a)

    Hw = H * Wt[:, None]
    M = np.concatenate([Hw.real, Hw.imag])
    for _ in range(120):
        R = H @ a
        phase = R / np.maximum(np.abs(R), 1e-30)
        rhs = s * phase * Wt
        a_new, *_ = np.linalg.lstsq(M, np.concatenate([rhs.real, rhs.imag]), rcond=None)
        if np.max(np.abs(a_new - a)) < 1e-10 * max(np.abs(a).max(), 1e-30):
            a = a_new
            break
        a = a_new
    err = pink_err(a)
    if err < best_err:
        best_a, best_err = a, err
    return p.astype(np.float32), best_a.astype(np.float32)


class PinkCascade:
    """K AR(1) streams sharing ONE innovation stream; their signed sum
    has the pink spectrum (a K-pole rational filter)."""

    def __init__(
        self,
        sample_rate: float,
        knee: float,
        beta: float = 1.0,
        T_ref: float = 4096.0,
        poles_per_decade: float = 2.0,
    ):
        self.sample_rate = float(sample_rate)
        self.knee = float(knee)
        p, a = _fit_cascade(sample_rate, knee, beta, T_ref, poles_per_decade)
        self.p = jnp.asarray(p)  # (K,)
        self.a = jnp.asarray(a)  # (K,)
        self.K = len(p)
        # stationary covariance of the shared-innovation states:
        # Cov(x_j, x_k) = 1 / (1 - p_j p_k); draw x0 = L z with C = L L^T
        p64 = np.asarray(p, dtype=np.float64)
        C = 1.0 / (1.0 - np.outer(p64, p64))
        for jitter in (0.0, 1e-12, 1e-9, 1e-6):
            try:
                L = np.linalg.cholesky(C + jitter * np.diag(np.diag(C)))
                break
            except np.linalg.LinAlgError:
                continue
        else:
            raise np.linalg.LinAlgError("cascade stationary covariance is not PD")
        self._chol0 = jnp.asarray(L, dtype=jnp.float32)

    def init_state(self, key, shape: tuple):
        """Stationary start with the correct cross-pole covariance."""
        z = jax.random.normal(key, (*shape, self.K), dtype=jnp.float32)
        return z @ self._chol0.T

    # sub-chunk length for the Toeplitz formulation: caps the (c, c)
    # kernel at 4 MB while keeping the matmuls MXU-sized
    _CHUNK = 1024

    @lru_cache(maxsize=8)
    def _toeplitz_tables(self, c: int):
        """Static f64-built tables for one sub-chunk of length c:
        LGT[j, t] = G(t - j) (t >= j) with G(d) = sum_k a_k p_k^d — the
        SINGLE causal kernel of the summed shared-innovation cascade;
        decay[k, t] = a_k p_k^(t+1) (the carried states' contribution);
        QT[j, k] = p_k^(c-1-j) (state update); pc[k] = p_k^c."""
        import scipy.linalg

        d = np.arange(c)
        p64 = np.asarray(self.p, np.float64)
        a64 = np.asarray(self.a, np.float64)
        pw = p64[:, None] ** d[None, :]  # (K, c)
        G = (a64[:, None] * pw).sum(0)  # (c,)
        LGT = scipy.linalg.toeplitz(G, np.zeros(c)).T  # (j, t) upper-tri
        decay = a64[:, None] * p64[:, None] * pw  # (K, c): a_k p_k^(t+1)
        QT = (p64[:, None] ** (c - 1 - d)[None, :]).T  # (j, k)
        # HOST arrays: caching device arrays here would cache tracers
        # when first built under a jit trace; jnp.asarray at the use
        # site turns them into (deduped) trace constants
        return (
            LGT.astype(np.float32),
            decay.astype(np.float32),
            QT.astype(np.float32),
            (p64**c).astype(np.float32),
        )

    def block(self, state, key, n: int):
        """(state, key, n) -> (new_state, pink (..., n)).

        The K AR(1) recursions x_k,t = p_k x_k,t-1 + w_t share ONE
        innovation, so their signed sum is an exact causal convolution
        with G(d) = sum_k a_k p_k^d plus the carried states' decay:

            pink_t = sum_k a_k p_k^(t+1) x_k,-1 + sum_{j<=t} G(t-j) w_j

        — two MXU matmuls per sub-chunk instead of an associative_scan
        (whose (.., K, n) affine-pair temporaries over log2(n) combine
        levels made the noise stage traffic-bound). Exact same process;
        pinned against the scan path in tests."""
        shape = state.shape[:-1]
        w = jax.random.normal(key, (*shape, n), dtype=jnp.float32)
        parts = []
        for i in range(0, n, self._CHUNK):
            wc = w[..., i : i + self._CHUNK]
            LGT, decay, QT, pc = (
                jnp.asarray(t) for t in self._toeplitz_tables(wc.shape[-1])
            )
            y = jnp.matmul(wc, LGT, precision=jax.lax.Precision.HIGHEST)
            y = y + jnp.matmul(state, decay, precision=jax.lax.Precision.HIGHEST)
            state = state * pc + jnp.matmul(wc, QT, precision=jax.lax.Precision.HIGHEST)
            parts.append(y)
        pink = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)
        return state, pink

    def block_scan(self, state, key, n: int):
        """Reference associative_scan implementation (kept for the
        equality test pinning `block`'s Toeplitz formulation)."""
        shape = state.shape[:-1]
        w = jax.random.normal(key, (*shape, n), dtype=jnp.float32)
        B = jnp.broadcast_to(w[..., None, :], (*shape, self.K, n))
        B = B.at[..., 0].add(self.p * state)
        A = jnp.broadcast_to(self.p[:, None], B.shape).astype(jnp.float32)

        def combine(l, r):  # compose affine maps, left-to-right in time
            return (r[0] * l[0], r[0] * l[1] + r[1])

        _, x = jax.lax.associative_scan(combine, (A, B), axis=-1)
        pink = jnp.einsum("k,...kn->...n", self.a, x)
        return x[..., -1], pink


class StreamingBandNoise:
    """Streaming counterpart of `generate_noise_with_knee` for one band:
    white + pink cascade + optional spatially-correlated modes projected
    through the focal-plane basis. Unit NEP; scale outside."""

    def __init__(self, sample_rate, knee, beta=1.0, basis=None, corr_prop=0.0, T_ref=4096.0):
        self.sample_rate = float(sample_rate)
        self.knee = float(knee)
        self.basis = None if basis is None else jnp.asarray(basis, dtype=jnp.float32)
        self.corr_prop = float(corr_prop) if self.basis is not None else 0.0
        self.cascade = PinkCascade(sample_rate, knee, beta, T_ref=T_ref) if knee > 0 else None

    def init_state(self, key, n_det: int):
        if self.cascade is None:
            return ()
        key_det, key_modes = jax.random.split(key)
        det_state = self.cascade.init_state(key_det, (n_det,))
        if self.corr_prop > 0:
            k = self.basis.shape[-1]
            return (det_state, self.cascade.init_state(key_modes, (k,)))
        return (det_state,)

    def block(self, state, key, n_det: int, n: int):
        key_white, key_pink, key_modes = jax.random.split(key, 3)
        noise = jnp.sqrt(self.sample_rate) * jax.random.normal(
            key_white, (n_det, n), dtype=jnp.float32
        )
        if self.cascade is None:
            return state, noise
        det_state, pink = self.cascade.block(state[0], key_pink, n)
        if self.corr_prop > 0:
            mode_state, mode_pink = self.cascade.block(state[1], key_modes, n)
            pink = (
                jnp.sqrt(self.corr_prop) * self.basis @ mode_pink
                + jnp.sqrt(1 - self.corr_prop) * pink
            )
            return (det_state, mode_state), noise + pink
        return (det_state,), noise + pink
