"""One-matmul banded noise synthesis fused with the TOD accumulate.

The per-band spectral path (generate_noise_with_knee -> irfft) leaves
~4 full-size memory passes AROUND the synthesis: the per-band output
buffers, the NEP scale, the cross-band concatenate, and the add into the
running total. This module removes them by reformulating the WHOLE
banded noise stage — every band, the NEP scales, the correlated
focal-plane component, and the final `total = signal * gains + noise`
accumulate — as ONE matmul with a fused elementwise epilogue:

    total = A + V @ B
    A = F * gains                                  (n_det, n)
    V = [ c_b * z_b  |  s_b * basis_b ]            (n_det, 2(m+1) + K)
    B = [ C ; S ; mode-noise time series ]         (2(m+1) + K, n)

where, per band b (bands are CONTIGUOUS row slices):
  - z_b ~ N(0,1) draws of shape (n_bdet, 2, m+1) (the frequency-domain
    white draw: the rfft of white noise IS complex white noise),
  - c_b = 1e12 * NEP_b * sqrt(sample_rate + (1-cp_b) w_b(f)^2) * white
    scale — the band's detector-noise half-spectrum amplitude with the
    NEP calibration FOLDED IN (so no post-scale pass exists),
  - C/S are the shared inverse-rfft cosine/sine bases evaluated only at
    the n kept samples (no n_fft truncation pass),
  - the correlated component rides K extra matmul columns: band b's
    static spatial basis occupies its own column block (s_b = 1e12 *
    NEP_b * sqrt(cp_b)), against per-realization mode time series rows
    (a tiny (k, 2(m+1)) @ (2(m+1), n) matmul).

XLA fuses the draw + spectral weighting into V's producer and the
`A +` epilogue into the matmul's output, so steady-state memory traffic
is one V write/read (bf16), one A read, one total write. The full-size
DFT costs ~30x the FLOPs of a split-radix FFT (n_det x 2(m+1) x n bf16
MACs); it pays only where the stage is bound by memory passes rather
than by those FLOPs — the `noise_total_matmul` gate of
maria_tpu/backend.py decides per platform.

Distribution contract: exactly the process of generate_noise_with_knee
(PSD sample_rate + (1-cp) w^2 detector part + cp-weighted correlated
modes; verified draw-exact against numpy irfft in f32 in
tests/test_noise_dft.py). Realizations differ from the other paths for
the same key (different draw order); the bf16 basis rounds sample
values by ~0.2% RMS — far below the noise's own realization scatter.

It is plain jnp, so it partitions under shard_map.

Reference behavior: maria/noise/generation.py:11-52.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NoiseBandSpec", "noise_total_matmul", "irfft_cos_sin_basis"]


@lru_cache(maxsize=16)
def irfft_cos_sin_basis(n_fft: int, n: int):
    """(C, S) float32 numpy bases, each (n_fft//2 + 1, n), such that
    numpy.fft.irfft(Z, n=n_fft)[:, :n] == Re(Z) @ C + Im(Z) @ S."""
    m = n_fft // 2
    k = np.arange(m + 1)[:, None]
    t = np.arange(n)[None, :]
    ang = 2 * np.pi * k * t / n_fft
    a = np.full(m + 1, 2.0)
    a[0] = 1.0
    if n_fft % 2 == 0:
        a[m] = 1.0
    C = (a[:, None] * np.cos(ang) / n_fft).astype(np.float32)
    S = (-(a[:, None]) * np.sin(ang) / n_fft).astype(np.float32)
    # edge bins are real: their sine rows are zero anyway (sin(0)=0,
    # sin(pi t)=0 for integer t), so imaginary edge draws self-cancel
    return C, S


@dataclass(frozen=True)
class NoiseBandSpec:
    """Static per-band inputs for noise_total_matmul. `start:stop` is
    the band's contiguous detector row slice; `c` is the NEP-scaled
    half-spectrum amplitude (see module docstring); `corr_cols` is the
    pre-scaled spatial basis (n_bdet, k) or None; `mode_c` the
    UNSCALED pink half-spectrum for the correlated modes."""

    start: int
    stop: int
    c: np.ndarray  # (m+1,) half-spectrum amplitude, NEP-scaled
    k_modes: int = 0
    mode_c: np.ndarray = None
    # the band's position in the program's config-ordered band list —
    # the fold_in index, so the noise key stream matches the per-band
    # path's convention even though specs walk in detector-row order
    key_index: int = None


def noise_total_matmul(
    key,
    A,
    specs,
    n: int,
    n_fft: int,
    corr_cols=None,
    basis_dtype=jnp.bfloat16,
    shared_c=None,
    row_scale=None,
):
    """total = A + banded noise, as one MXU matmul (module docstring).

    `A` is the already-gained signal sum (n_det, n) f32 (or anything
    broadcastable); `specs` a list of NoiseBandSpec whose slices
    partition [0, n_det); `corr_cols` the concatenated per-band scaled
    basis columns (n_det, K_total) f32 numpy/jnp, column blocks aligned
    with the specs' `k_modes` (None when no band has correlated noise).
    `key` is the noise key; band b draws from fold_in(key, b).

    When every band shares one normalized spectral SHAPE (same knee /
    corr_prop / sample_rate — e.g. all 9 AtLAST bands), pass that
    shape as `shared_c` (m+1,) and the per-detector amplitude (1e12 *
    NEP) as `row_scale` (n_det, 1): the draw collapses to ONE
    whole-axis threefry op (instead of 9 per-band draw+scale+concat
    fusions), the column scale is a tiny shared constant, and the NEP lands as a
    row scalar in the matmul's fused epilogue. `corr_cols` must then
    carry sqrt(cp) * basis WITHOUT the NEP factor. The shared-shape
    path draws a single stream keyed by `key` (a different realization
    of the same process than the per-band path)."""
    m1 = n_fft // 2 + 1
    C, S = irfft_cos_sin_basis(n_fft, n)
    B_const = jnp.asarray(np.concatenate([C, S], axis=0), dtype=basis_dtype)

    mode_rows = []
    for i, sp in enumerate(specs):
        band_key = jax.random.fold_in(key, sp.key_index if sp.key_index is not None else i)
        # same stream layout as generate_noise_with_knee (white stream
        # unused: the white component is folded into the spectral draw)
        _key_white, key_pink, key_modes = jax.random.split(band_key, 3)
        if sp.k_modes:
            zm = jax.random.normal(key_modes, (sp.k_modes, 2, m1), dtype=jnp.float32)
            mc = jnp.asarray(np.asarray(sp.mode_c, dtype=np.float32))
            # tiny matmul: per-realization mode time series (k, n)
            mode_rows.append(((zm * mc).reshape(sp.k_modes, 2 * m1) @
                              jnp.asarray(np.concatenate([C, S], axis=0))))

    if shared_c is not None:
        n_det = specs[-1].stop
        z = jax.random.normal(key, (n_det, 2, m1), dtype=jnp.float32)
        c = jnp.asarray(np.asarray(shared_c, dtype=np.float32))
        V = (z * c).reshape(n_det, 2 * m1).astype(basis_dtype)
    else:
        v_parts = []
        for i, sp in enumerate(specs):
            band_key = jax.random.fold_in(key, sp.key_index if sp.key_index is not None else i)
            _kw, key_pink, _km = jax.random.split(band_key, 3)
            n_bdet = sp.stop - sp.start
            z = jax.random.normal(key_pink, (n_bdet, 2, m1), dtype=jnp.float32)
            c = jnp.asarray(np.asarray(sp.c, dtype=np.float32))
            v_parts.append((z * c).reshape(n_bdet, 2 * m1))
        V = jnp.concatenate(v_parts, axis=0).astype(basis_dtype)

    B = B_const
    if mode_rows:
        V = jnp.concatenate([V, jnp.asarray(corr_cols).astype(basis_dtype)], axis=1)
        B = jnp.concatenate([B, jnp.concatenate(mode_rows, axis=0).astype(basis_dtype)],
                            axis=0)
    noise = jnp.dot(V, B, preferred_element_type=jnp.float32)
    if row_scale is not None:
        noise = jnp.asarray(row_scale) * noise
    return A + noise


def band_half_spectrum(sample_rate: float, knee: float, beta: float, n_fft: int,
                       corr_prop: float = 0.0, pink_only: bool = False) -> np.ndarray:
    """The (m+1,) half-spectrum amplitude c(f) of the band's noise
    process (white + pink with a knee), INCLUDING the spectral-white
    draw scale (noise/__init__._pink_weights_np and
    _spectral_white_scale_np are the single source)."""
    from . import _pink_weights_np, _spectral_white_scale_np

    w = _pink_weights_np(n_fft, sample_rate, knee, beta)
    if pink_only:
        base = w**2
    else:
        base = sample_rate + (1.0 - corr_prop) * w**2
    return np.sqrt(base) * _spectral_white_scale_np(n_fft)
