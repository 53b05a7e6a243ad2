"""Tests that need a CUDA device (marker `gpu`).

They compare what the card computes with the CPU or with numpy at small
sizes; `chip_smoke.py` repeats the comparisons at full width. Run on the
card with `JAX_PLATFORMS= python -m pytest tests -m gpu`; elsewhere the
`gpu` fixture skips them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import maria_tpu
from maria_tpu.ops.program import build_tod_program

pytestmark = pytest.mark.gpu


def _on(device, fn, *args):
    with jax.default_device(device):
        args = [jax.device_put(a, device) for a in args]
        return np.asarray(jax.jit(fn)(*args))


def test_fused_program_card_matches_cpu(gpu):
    """The same program and key give the same TOD on the card and on
    the CPU, under `highest` matmul precision (TF32 off)."""
    plan = maria_tpu.get_plan("ten_second_zenith_stare", start_time=1.75e9)
    sim = maria_tpu.Simulation(instrument="MUSTANG-2", plans=plan, site="green_bank",
                               atmosphere="2d", noise=True, seed=4)
    program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs)
    fn = program.total_power_fn()

    def run(device):
        with jax.default_device(device):
            args = program.example_args(jax.device_put(jax.random.key(2), device))
            return np.asarray(jax.jit(fn)(*args, tables=program.device_tables()))

    with jax.default_matmul_precision("highest"):
        card, cpu = run(gpu), run(jax.devices("cpu")[0])
    assert np.isfinite(card).all()
    scale = np.std(cpu - cpu.mean(axis=-1, keepdims=True))
    assert np.sqrt(np.mean((card - cpu) ** 2)) < 1e-3 * scale


def test_run_plan_binning_on_card_matches_bincount(gpu):
    from maria_tpu.ops.binning_runs import bin_runchunk, make_runchunk_bin_plan_on_device

    rng = np.random.default_rng(0)
    n_det, n_t, n = 256, 2048, 64
    iy = np.clip(20 + np.cumsum(rng.integers(-1, 2, (n_det, n_t)), axis=1) // 8, 0, n - 1)
    ix = np.clip(30 + np.cumsum(rng.integers(-1, 2, (n_det, n_t)), axis=1) // 8, 0, n - 1)
    iy, ix = iy.astype(np.int32), ix.astype(np.int32)
    data = rng.standard_normal((n_det, n_t)).astype(np.float32)
    with jax.default_device(gpu):
        plan = make_runchunk_bin_plan_on_device(jnp.asarray(iy), jnp.asarray(ix), n, n)
        assert plan is not None
        out = np.asarray(jax.jit(lambda d, *a: bin_runchunk(
            jnp.stack([d, jnp.ones_like(d)]), plan, e_idx=a[0], run_ly=a[1], run_lx=a[2],
            origins=a[3], order=a[4], wcnt=a[5], precision="hilo"))(
                jax.device_put(data, gpu), *plan.device_args()))
    pix = (iy * n + ix).ravel()
    np.testing.assert_array_equal(out[1].ravel(), np.bincount(pix, minlength=n * n))
    ref = np.bincount(pix, weights=data.ravel().astype(np.float64), minlength=n * n)
    np.testing.assert_allclose(out[0].ravel(), ref, atol=1e-4 * np.abs(ref).max())


def test_irfft_paths_on_card_match_numpy(gpu):
    from maria_tpu.ops.fft import irfft_matmul

    rng = np.random.default_rng(1)
    n_fft = 3072
    z = (rng.standard_normal((64, n_fft // 2 + 1))
         + 1j * rng.standard_normal((64, n_fft // 2 + 1))).astype(np.complex64)
    ref = np.fft.irfft(z.astype(np.complex128), n=n_fft)
    scale = np.abs(ref).max()
    xla = _on(gpu, lambda z: jnp.fft.irfft(z, n=n_fft), z)
    np.testing.assert_allclose(xla, ref, atol=1e-5 * scale)
    with jax.default_matmul_precision("highest"):
        mm = _on(gpu, lambda z: irfft_matmul(z, n_fft), z)
    np.testing.assert_allclose(mm, ref, atol=1e-4 * scale)


def test_noise_total_matmul_on_card_has_the_band_level(gpu):
    """The fused noise matmul (bf16 basis, TF32/bf16 products on the
    card) keeps the per-band noise level of the spectral path."""
    from maria_tpu.noise.dft import NoiseBandSpec, band_half_spectrum, noise_total_matmul

    n, n_fft = 1000, 1024
    c = band_half_spectrum(50.0, 1.0, 1.0, n_fft)
    specs = [NoiseBandSpec(start=0, stop=512, c=2.0 * c, key_index=0)]
    with jax.default_device(gpu):
        x = np.asarray(jax.jit(lambda k: noise_total_matmul(k, 0.0, specs, n=n, n_fft=n_fft))(
            jax.device_put(jax.random.key(3), gpu)))
        y = np.asarray(jax.jit(lambda k: noise_total_matmul(
            k, 0.0, specs, n=n, n_fft=n_fft, basis_dtype=jnp.float32))(
            jax.device_put(jax.random.key(4), gpu)))
    assert np.isfinite(x).all()
    assert abs(x.std() / y.std() - 1) < 0.03
