"""The one-matmul banded noise total (noise/dft.py): draw-exactness
against numpy irfft, process equivalence with generate_noise_with_knee,
and the program-level fused path (reference behavior:
maria/noise/generation.py:11-52)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import maria_tpu
from maria_tpu.noise import _pink_weights_np, _spectral_white_scale_np
from maria_tpu.noise.dft import (
    NoiseBandSpec,
    band_half_spectrum,
    irfft_cos_sin_basis,
    noise_total_matmul,
)

SR = 50.0


def test_cos_sin_basis_is_irfft():
    """irfft(Z, n_fft)[:, :n] == Re(Z) @ C + Im(Z) @ S, any spectrum."""
    n_fft, n = 96, 90
    rng = np.random.default_rng(0)
    Z = rng.standard_normal((5, n_fft // 2 + 1)) + 1j * rng.standard_normal((5, n_fft // 2 + 1))
    C, S = irfft_cos_sin_basis(n_fft, n)
    ref = np.fft.irfft(Z, n=n_fft, axis=-1)[:, :n]
    got = Z.real.astype(np.float32) @ C + Z.imag.astype(np.float32) @ S
    np.testing.assert_allclose(got, ref, atol=2e-6)


def _draw_exact_reference(key, specs, n, n_fft):
    """The exact expected noise for noise_total_matmul's key stream,
    via numpy irfft on the SAME draws (documents the draw convention)."""
    m1 = n_fft // 2 + 1
    rows = []
    for i, sp in enumerate(specs):
        band_key = jax.random.fold_in(key, sp.key_index if sp.key_index is not None else i)
        _w, key_pink, _m = jax.random.split(band_key, 3)
        z = np.asarray(jax.random.normal(key_pink, (sp.stop - sp.start, 2, m1)))
        Z = np.asarray(sp.c) * (z[:, 0] + 1j * z[:, 1])
        rows.append(np.fft.irfft(Z, n=n_fft, axis=-1)[:, :n])
    return np.concatenate(rows, axis=0)


def test_matmul_noise_draw_exact():
    """f32-basis matmul == irfft of the same draws, two bands, plus the
    A accumulate."""
    n, n_fft = 300, 320
    key = jax.random.key(7)
    specs = [
        NoiseBandSpec(0, 13, c=2.5 * band_half_spectrum(SR, 0.5, 1.0, n_fft), key_index=0),
        NoiseBandSpec(13, 20, c=1.1 * band_half_spectrum(SR, 0.0, 1.0, n_fft), key_index=1),
    ]
    A = jnp.asarray(np.linspace(-1, 1, 20 * n, dtype=np.float32).reshape(20, n))
    total = np.asarray(noise_total_matmul(key, A, specs, n=n, n_fft=n_fft,
                                          basis_dtype=jnp.float32))
    ref = np.asarray(A) + _draw_exact_reference(key, specs, n, n_fft)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(total, ref, atol=2e-4 * scale)


def test_matmul_noise_psd_matches_process():
    """The synthesized PSD matches the analytic model
    sample_rate + (1 - cp) * w(f)^2 (NEP-normalized), i.e. the same
    process generate_noise_with_knee draws from."""
    n = n_fft = 4096
    knee, nep = 1.0, 1.0
    c = nep * band_half_spectrum(SR, knee, 1.0, n_fft)
    specs = [NoiseBandSpec(0, 256, c=c, key_index=0)]
    x = np.asarray(
        noise_total_matmul(jax.random.key(3), 0.0, specs, n=n, n_fft=n_fft,
                           basis_dtype=jnp.float32)
    )
    psd = (np.abs(np.fft.rfft(x, axis=-1)) ** 2).mean(axis=0) * 2 / (n * SR)
    w2 = _pink_weights_np(n_fft, SR, knee, 1.0) ** 2
    # process variance (SR + w^2) per sample -> one-sided PSD 2 var / SR
    model = 2 * (SR + w2) / SR
    sel = slice(4, n // 2)  # skip DC/lowest bins (few modes) and Nyquist
    ratio = psd[sel] / model[sel]
    # 256 detectors -> ~6% rms per bin; band-average much tighter
    assert abs(np.mean(ratio) - 1) < 0.05
    assert np.all((ratio > 0.6) & (ratio < 1.6))


def test_matmul_noise_correlated_component():
    """Correlated columns add the cp-weighted low-rank component: with
    a rank-1 constant basis, neighboring detectors correlate by ~cp at
    low frequency."""
    n = n_fft = 2048
    n_det, cp = 128, 0.7
    c = band_half_spectrum(SR, 2.0, 1.0, n_fft, corr_prop=cp)
    mode_c = band_half_spectrum(SR, 2.0, 1.0, n_fft, pink_only=True)
    specs = [NoiseBandSpec(0, n_det, c=c, k_modes=1, mode_c=mode_c, key_index=0)]
    corr_cols = np.full((n_det, 1), np.sqrt(cp), np.float32)
    x = np.asarray(
        noise_total_matmul(jax.random.key(11), 0.0, specs, n=n, n_fft=n_fft,
                           corr_cols=corr_cols, basis_dtype=jnp.float32)
    )
    # the shared mode dominates the pink band: low-pass and correlate
    from scipy.ndimage import uniform_filter1d

    lp = uniform_filter1d(x, size=101, axis=-1)
    cmat = np.corrcoef(lp[:16])
    off_diag = cmat[np.triu_indices(16, k=1)]
    assert off_diag.mean() > 0.4  # uncorrelated would be ~0


def _tiny_program(monkeypatch=None):
    plan = maria_tpu.get_plan(
        "stare", start_time=1.75e9, scan_center=(150.0, 40.0), frame="az/el",
        duration=12.0, sample_rate=16.0,
    )
    sim = maria_tpu.Simulation(
        instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d",
        noise=True, seed=0,
    )
    from maria_tpu.ops.program import build_tod_program

    return build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs), sim.obs_list[0]


def test_program_fused_total_matches_fields_path(monkeypatch):
    """Program-level: the matmul total's signal part is IDENTICAL to the
    per-band path (same key -> same atmosphere/gains) and its noise
    residual has the band's NEP-scaled std."""
    program, _ = _tiny_program()
    key = jax.random.key(5)
    args = program.example_args(key)
    tables = program.device_tables()

    monkeypatch.setenv("MARIA_TPU_NOISE_TOTAL", "matmul")
    assert program.use_noise_matmul()
    total_m = np.asarray(jax.jit(program.total_power_fn())(*args, tables))

    monkeypatch.setenv("MARIA_TPU_NOISE_TOTAL", "fields")
    assert not program.use_noise_matmul()
    total_f = np.asarray(jax.jit(program.total_power_fn())(*args, tables))

    assert total_m.shape == total_f.shape
    assert np.isfinite(total_m).all()

    # same signal component: subtracting each path's own noise must
    # leave the same gained field sum
    fields = jax.jit(lambda *a: program._loadings(*a[:4], tables=a[4]))(*args, tables)
    gains = np.asarray(jax.jit(program.draw_gains)(key))
    signal = sum(np.asarray(v) for k, v in fields.items() if k != "noise") * gains
    noise_m = total_m - signal
    noise_f = total_f - signal
    np.testing.assert_allclose(noise_f, np.asarray(fields["noise"]), rtol=0, atol=1e-3)

    # equal process: matched std (bf16 basis rounds ~0.2%; realization
    # scatter over 217 x 400 samples ~ 0.5%)
    assert abs(noise_m.std() / noise_f.std() - 1) < 0.05
    # and matched per-detector white level at high frequency
    d_m = np.diff(noise_m, axis=-1).std()
    d_f = np.diff(noise_f, axis=-1).std()
    assert abs(d_m / d_f - 1) < 0.05


def test_streaming_noise_untouched_by_gate(monkeypatch):
    """fields_fn still returns a separate per-band noise field whatever
    the gate says (the streaming executor depends on it)."""
    program, _ = _tiny_program()
    monkeypatch.setenv("MARIA_TPU_NOISE_TOTAL", "matmul")
    key = jax.random.key(2)
    fields, _pwv = jax.jit(program.fields_fn())(*program.example_args(key))
    assert "noise" in fields and np.isfinite(np.asarray(fields["noise"])).all()


def test_shared_shape_row_scale_path():
    """Bands sharing a spectral shape ride the single-draw path with
    NEP as an epilogue row scale: per-band stds must still track NEP."""
    n, n_fft = 2000, 2048
    shape = band_half_spectrum(SR, 0.5, 1.0, n_fft)
    specs = [
        NoiseBandSpec(0, 64, c=2.5 * shape, key_index=0),
        NoiseBandSpec(64, 128, c=1.1 * shape, key_index=1),
    ]
    row_scale = np.concatenate([np.full((64, 1), 2.5), np.full((64, 1), 1.1)]).astype(np.float32)
    x = np.asarray(noise_total_matmul(jax.random.key(21), 0.0, specs, n=n, n_fft=n_fft,
                                      shared_c=shape, row_scale=row_scale,
                                      basis_dtype=jnp.float32))
    r = x[:64].std() / x[64:].std()
    assert abs(r - 2.5 / 1.1) < 0.08 * (2.5 / 1.1)
    # and the absolute level matches the per-band path's process
    y = np.asarray(noise_total_matmul(jax.random.key(21), 0.0, specs, n=n, n_fft=n_fft,
                                      basis_dtype=jnp.float32))
    assert abs(x[:64].std() / y[:64].std() - 1) < 0.05
