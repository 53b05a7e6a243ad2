"""The fourier 3-D atmosphere: vertically-correlated layer screens as
slices of one 3-D Matérn field (reference behavior anchor: the stacked
cross-section AR process, maria/atmosphere/atmosphere.py:203-257)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import maria_tpu
from maria_tpu import Simulation, get_plan
from maria_tpu.atmosphere.fourier import (
    layered_field_spectral_weights,
    synthesize_layered_matern_2d,
    white_rfft2_spectrum,
)
from maria_tpu.functions import approximate_normalized_matern


def test_white_rfft2_spectrum_matches_rfft2_statistics():
    """The k-space white draw must be distributed exactly as
    rfft2(white): interior bins complex with per-component variance N/2,
    the kx=0 / kx=nx/2 columns Hermitian along ky with real variance-N
    self-conjugate bins — so irfft2 of it is unit-variance white noise."""
    ny, nx = 16, 24
    N = ny * nx
    keys = jax.random.split(jax.random.key(0), 2000)
    f = jax.jit(lambda k: white_rfft2_spectrum(k, (), ny, nx))
    Z = np.stack([np.asarray(f(k)) for k in keys])

    # exact Hermitian symmetry of the self-conjugate columns
    for col in (0, -1):
        np.testing.assert_array_equal(
            Z[:, 1:, col], np.conj(Z[:, ::-1, col][:, :-1])
        )
        assert np.all(Z[:, 0, col].imag == 0)
        assert np.all(Z[:, ny // 2, col].imag == 0)

    # per-bin variances
    vr, vi = Z.real.var(0), Z.imag.var(0)
    assert abs(vr[:, 1:-1].mean() / N - 0.5) < 0.02
    assert abs(vi[:, 1:-1].mean() / N - 0.5) < 0.02
    assert abs(vr[0, 0] / N - 1.0) < 0.15
    assert abs(vr[ny // 2, 0] / N - 1.0) < 0.15

    # the implied real field is unit-variance white
    x = np.fft.irfft2(Z, s=(ny, nx))
    assert abs(x.var() - 1.0) < 0.02
    assert abs((x[:, :, :-1] * x[:, :, 1:]).mean()) < 0.02
    assert abs((x[:, :-1] * x[:, 1:]).mean()) < 0.02


@pytest.mark.slow
def test_layered_synthesis_cross_covariance():
    """Realization-averaged layer cross-correlations must match the 3-D
    Matérn closed form (the same covariance the AR path's stacked
    cross-section targets)."""
    heights = np.array([100.0, 400.0, 1000.0, 2500.0])
    nu, r0 = 1 / 3, 1000.0
    ny = nx = 64
    W, Mc, Ms, _ = layered_field_spectral_weights(ny, nx, 40.0, 40.0, heights, nu, r0)
    Wd, Mcd, Msd = jnp.asarray(W), jnp.asarray(Mc), jnp.asarray(Ms)

    @jax.jit
    def point_vals(key):
        f = synthesize_layered_matern_2d(key, Wd, Mcd, Msd, None, ny, nx)
        return f[:, ::16, ::16].reshape(len(heights), -1)

    # 800 realizations: the per-layer variance estimator scatters
    # ~±0.04 at 400 (spatially correlated sample points), too close to
    # the 0.1 tolerance
    keys = jax.random.split(jax.random.key(0), 800)
    vals = np.concatenate([np.asarray(point_vals(k)) for k in keys], axis=1)
    var = (vals**2).mean(axis=1)
    np.testing.assert_allclose(var, 1.0, atol=0.1)

    C = (vals @ vals.T) / vals.shape[1]
    Cn = C / np.sqrt(np.outer(var, var))
    for a in range(len(heights)):
        for b in range(a + 1, len(heights)):
            dz = heights[b] - heights[a]
            tgt = float(approximate_normalized_matern(np.array([dz]), nu=nu, r0=r0)[0])
            assert abs(Cn[a, b] - tgt) < 0.08, (dz, Cn[a, b], tgt)


def test_beam_smoothing_reduces_small_scale_power():
    heights = np.array([500.0, 1500.0])
    ny = nx = 64
    W, Mc, Ms, beam = layered_field_spectral_weights(
        ny, nx, 10.0, 10.0, heights, 1 / 3, 1000.0, beam_sigmas=[40.0, 40.0]
    )
    key = jax.random.key(3)
    smooth = np.asarray(synthesize_layered_matern_2d(key, W, Mc, Ms, jnp.asarray(beam), ny, nx))
    rough = np.asarray(synthesize_layered_matern_2d(key, W, Mc, Ms, None, ny, nx))
    # gradient power drops under smoothing
    assert np.abs(np.diff(smooth, axis=-1)).mean() < 0.7 * np.abs(np.diff(rough, axis=-1)).mean()


@pytest.fixture(scope="module")
def stare_plan():
    return get_plan("five_second_stare", start_time=1.75e9, scan_center=(60.0, 45.0))


def test_3d_fourier_sim_fused(stare_plan):
    sim = Simulation(
        instrument="test/1deg", plans=stare_plan, site="chajnantor",
        atmosphere="3d", noise=False, seed=0,
    )
    atm = sim.obs_list[0].atmosphere
    assert len(atm.groups) == 1 and len(atm.screens) == 0
    assert len(atm.groups[0].heights) == 12
    tod = sim.run()[0]
    d = np.asarray(tod.data["atmosphere"])
    assert np.isfinite(d).all()
    assert d.std() > 0


@pytest.mark.slow
def test_3d_fourier_vs_ar_statistics(stare_plan):
    """The fused AR extrusion and the layered fourier synthesis target
    the same 3-D covariance; their TOD fluctuations must agree in
    distribution."""
    stds = {}
    for method in ("fourier", "ar"):
        sim = Simulation(
            instrument="test/1deg", plans=stare_plan, site="chajnantor",
            atmosphere="3d", method=method, noise=False, seed=11,
        )
        tod = sim.run()[0]
        d = np.asarray(tod.data["atmosphere"])
        assert np.isfinite(d).all()
        stds[method] = (d - d.mean()).std()
    ratio = stds["fourier"] / stds["ar"]
    assert 0.5 < ratio < 2.0, stds


@pytest.mark.slow
def test_2d_ar_method_uses_processes(stare_plan):
    sim = Simulation(
        instrument="test/1deg", plans=stare_plan, site="chajnantor",
        atmosphere="2d", method="ar", noise=False, seed=2,
    )
    atm = sim.obs_list[0].atmosphere
    assert all(s.process is not None for s in atm.screens)
    tod = sim.run()[0]
    assert np.isfinite(np.asarray(tod.data["atmosphere"])).all()


def test_fused_group_sampler_equals_per_layer_path():
    """_sample_group_windowed (one scan over time chunks, all layers
    accumulated in-body) must reproduce the per-layer
    interp_bilinear_windowed loop bit-for-bit in f32 tolerance, including
    per-layer windows smaller than the group max."""
    from maria_tpu.atmosphere.atmosphere import ScreenGroup
    from maria_tpu.atmosphere.sampling import _sample_group_windowed, _sample_layer

    rng = np.random.default_rng(7)
    L, ny, nx = 3, 48, 64
    n_det, n_t = 13, 57
    res = 10.0
    heights = np.array([300.0, 900.0, 2000.0])
    group = ScreenGroup(
        heights=heights,
        zs=heights * 1.2,
        pwv_rms=np.array([0.3, 0.2, 0.1]),
        angle=0.4,
        vx=1.5,
        vy=-0.7,
        res=res,
        tx_min=-nx * res / 2,
        ty_min=-ny * res / 2,
        nx=nx,
        ny=ny,
        W=None,
        M_cos=None,
        M_sin=None,
        win_x=np.array([8, 16, 24]),
        win_y=np.array([8, 16, 24]),
    )
    stack = jnp.asarray(rng.standard_normal((L, ny, nx)).astype(np.float32))
    # LOS unit-height projections small enough that every layer's span
    # fits its own window
    px = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    px = px + jnp.zeros((1, n_t), jnp.float32)
    py = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    py = py + jnp.zeros((1, n_t), jnp.float32)
    bs = jnp.zeros((n_t,), jnp.float32)
    t_rel = jnp.asarray(np.linspace(0.0, 20.0, n_t).astype(np.float32))

    fused = np.asarray(
        jax.jit(
            lambda s, px, py, b, t: _sample_group_windowed(
                s, group, px, py, b, b, t, chunk=16
            )
        )(stack, px, py, bs, t_rel)
    )
    ref = np.zeros((n_det, n_t), np.float32)
    for il, h in enumerate(heights):
        s = _sample_layer(
            stack[il], float(h), group.angle, group.vx, group.vy,
            group.res, group.res, group.tx_min, group.ty_min,
            int(group.win_x[il]), int(group.win_y[il]),
            px, py, bs, bs, t_rel,
        )
        ref += float(group.pwv_rms[il]) * np.asarray(s)
    np.testing.assert_allclose(fused, ref, rtol=2e-5, atol=2e-5)


def test_group_sampler_bf16_close_to_f32():
    """The opt-in bf16 hat-einsum path (halves the sampler's hat
    traffic) must stay within ~2^-7 of the f32 path on a unit-variance
    stack. On CPU XLA promotes bf16 dots to f32 so the paths agree
    exactly; the tolerance is sized for real bf16 matrix-unit passes so
    the same test is meaningful on an accelerator."""
    from maria_tpu.atmosphere.atmosphere import ScreenGroup
    from maria_tpu.atmosphere.sampling import _sample_group_windowed

    rng = np.random.default_rng(11)
    L, ny, nx = 2, 32, 64
    n_det, n_t = 9, 40
    res = 10.0
    heights = np.array([300.0, 1500.0])
    group = ScreenGroup(
        heights=heights, zs=heights * 1.2, pwv_rms=np.array([0.3, 0.1]),
        angle=-0.2, vx=1.0, vy=0.5, res=res,
        tx_min=-nx * res / 2, ty_min=-ny * res / 2, nx=nx, ny=ny,
        W=None, M_cos=None, M_sin=None,
        win_x=np.array([8, 16]), win_y=np.array([8, 16]),
    )
    stack = jnp.asarray(rng.standard_normal((L, ny, nx)).astype(np.float32))
    px = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    px = px + jnp.zeros((1, n_t), jnp.float32)
    py = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    py = py + jnp.zeros((1, n_t), jnp.float32)
    bs = jnp.zeros((n_t,), jnp.float32)
    t_rel = jnp.asarray(np.linspace(0.0, 10.0, n_t).astype(np.float32))

    args = (stack, px, py, bs, bs, t_rel)
    f32 = np.asarray(_sample_group_windowed(*((args[0], group) + args[1:]), bf16=False))
    b16 = np.asarray(_sample_group_windowed(*((args[0], group) + args[1:]), bf16=True))
    scale = max(np.abs(f32).max(), 1e-12)
    assert np.abs(b16 - f32).max() <= 2e-2 * scale


def test_upsample_linear_indices_matches_np_interp():
    from maria_tpu.atmosphere.sampling import _upsample_linear_indices

    rng = np.random.default_rng(13)
    for n_t, d in [(58, 4), (57, 4), (40, 8), (11, 16), (7, 3), (5, 4)]:
        d_eff = min(d, n_t - 1)
        sel = np.arange(0, n_t, d_eff)
        aligned = sel[-1] == n_t - 1
        if not aligned:
            sel = np.append(sel, n_t - 1)
        a = rng.standard_normal((3, len(sel))).astype(np.float32)
        got = np.asarray(
            _upsample_linear_indices(jnp.asarray(a), d_eff, n_t, bool(aligned))
        )
        fine = np.arange(n_t)
        want = np.stack([np.interp(fine, sel, row) for row in a]).astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"n_t={n_t} d={d_eff}")


def _make_test_group(dec=None, n_layers=2):
    from maria_tpu.atmosphere.atmosphere import ScreenGroup

    ny, nx = 48, 64
    res = 10.0
    heights = np.array([300.0, 2000.0])[:n_layers]
    return ScreenGroup(
        heights=heights, zs=heights * 1.2,
        pwv_rms=np.array([0.3, 0.1])[:n_layers],
        angle=0.3, vx=1.0, vy=-0.4, res=res,
        tx_min=-nx * res / 2, ty_min=-ny * res / 2, nx=nx, ny=ny,
        W=None, M_cos=None, M_sin=None,
        win_x=np.array([8, 16])[:n_layers], win_y=np.array([8, 16])[:n_layers],
        dec=dec,
    ), ny, nx


def test_group_sampler_decimation_close_and_exact_on_grid():
    """Per-layer temporal decimation: sampling a layer every d-th coarse
    step and lerping must (a) reproduce the undecimated samples EXACTLY
    at the decimated time indices, and (b) stay within a small fraction
    of the sample rms everywhere on a beam-smoothed (cell-scale-smooth)
    screen — the same error class as the spatial bilinear interp."""
    from scipy.ndimage import gaussian_filter

    from maria_tpu.atmosphere.sampling import _sample_group_windowed

    rng = np.random.default_rng(21)
    group, ny, nx = _make_test_group(dec=np.array([4, 1]))
    n_det, n_t = 9, 58  # (n_t-1) % 4 != 0: exercises the appended endpoint
    stack = np.stack(
        [gaussian_filter(rng.standard_normal((ny, nx)), 2.0) for _ in range(2)]
    ).astype(np.float32)
    stack = jnp.asarray(stack / stack.std(axis=(1, 2), keepdims=True))
    px = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    px = px + jnp.zeros((1, n_t), jnp.float32)
    py = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    py = py + jnp.zeros((1, n_t), jnp.float32)
    bs = jnp.zeros((n_t,), jnp.float32)
    t_rel = jnp.asarray(np.linspace(0.0, 30.0, n_t).astype(np.float32))

    args = (stack, group, px, py, bs, bs, t_rel)
    full = np.asarray(_sample_group_windowed(*args, decimate=False))
    decd = np.asarray(_sample_group_windowed(*args, decimate=True))

    sel = np.append(np.arange(0, n_t, 4), n_t - 1)
    np.testing.assert_allclose(decd[:, sel], full[:, sel], rtol=2e-5, atol=2e-5)
    scale = full.std()
    assert np.abs(decd - full).max() < 0.05 * scale, (
        np.abs(decd - full).max(), scale
    )


def test_group_sampler_dec_none_is_bitwise_unchanged():
    from maria_tpu.atmosphere.sampling import _sample_group_windowed

    rng = np.random.default_rng(2)
    group, ny, nx = _make_test_group(dec=None)
    group1, _, _ = _make_test_group(dec=np.array([1, 1]))
    n_det, n_t = 5, 33
    stack = jnp.asarray(rng.standard_normal((2, ny, nx)).astype(np.float32))
    px = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    px = px + jnp.zeros((1, n_t), jnp.float32)
    py = jnp.asarray(rng.uniform(-8e-3, 8e-3, (n_det, 1)).astype(np.float32))
    py = py + jnp.zeros((1, n_t), jnp.float32)
    bs = jnp.zeros((n_t,), jnp.float32)
    t_rel = jnp.asarray(np.linspace(0.0, 10.0, n_t).astype(np.float32))

    a = np.asarray(_sample_group_windowed(stack, group, px, py, bs, bs, t_rel))
    b = np.asarray(_sample_group_windowed(stack, group1, px, py, bs, bs, t_rel))
    assert (a == b).all()


def test_atmosphere_setup_assigns_layer_decimation():
    """The 3-D fourier setup must attach per-layer decimation factors:
    low layers (slow LOS drift in cells) decimate harder than high ones,
    and tol=0 disables decimation."""
    from maria_tpu import get_instrument, get_site
    from maria_tpu.atmosphere.atmosphere import Atmosphere
    from maria_tpu.sim.observation import Observation

    plan = get_plan("ten_second_zenith_stare")
    obs = Observation(
        instrument=get_instrument("test/1deg"), site=get_site("chajnantor"), plan=plan
    )
    atm = Atmosphere(model="3d", region="chajnantor", sampler_dec_tol=0.35)
    atm.initialize(obs)
    g = atm.groups[0]
    assert g.dec is not None and len(g.dec) == len(g.heights)
    assert (g.dec >= 1).all()
    assert g.dec[0] >= g.dec[-1]  # lowest layer drifts slowest

    atm0 = Atmosphere(model="3d", region="chajnantor", sampler_dec_tol=0.0)
    atm0.initialize(obs)
    assert (atm0.groups[0].dec == 1).all()


def _make_static_group(heights, win, nx=64, ny=48, res=8.0, angle=0.0, vx=0.0, vy=0.0):
    from maria_tpu.atmosphere.atmosphere import ScreenGroup

    heights = np.asarray(heights, dtype=float)
    return ScreenGroup(
        heights=heights, zs=heights * 1.2,
        pwv_rms=np.linspace(0.3, 0.1, len(heights)),
        angle=angle, vx=vx, vy=vy, res=res,
        tx_min=-nx * res / 2, ty_min=-ny * res / 2, nx=nx, ny=ny,
        W=None, M_cos=None, M_sin=None,
        win_x=np.asarray(win), win_y=np.asarray(win),
        hat_static=np.ones(len(heights), dtype=bool),
    ), ny, nx


def test_static_hat_sampler_exact_on_grid():
    """When the boresight track lands exactly on screen cells (uf=vf=0)
    and detector offsets are rigid, the static-hat GEMM sampler reduces
    to the same windowed bilinear contraction as the scan path — equal to
    f32 tolerance. (h=1024, res=8, track steps of res/h keep every
    quantity exactly representable in binary.)"""
    from maria_tpu.atmosphere.sampling import _sample_group_windowed

    rng = np.random.default_rng(5)
    group, ny, nx = _make_static_group([1024.0, 2048.0], [8, 16])
    n_det, n_t = 11, 41
    stack = jnp.asarray(rng.standard_normal((2, ny, nx)).astype(np.float32))
    k = rng.integers(-3, 4, n_t)
    bs = jnp.asarray((k / 128.0).astype(np.float32))  # u_1024 = k + nx/2
    q = rng.integers(-4, 5, n_det) / 256.0  # |1024*q/8| <= 2 cells
    px = jnp.asarray((q[:, None] + k[None, :] / 128.0).astype(np.float32))
    qy = rng.integers(-4, 5, n_det) / 256.0
    py = jnp.asarray((qy[:, None] + np.zeros((1, n_t))).astype(np.float32))
    bs_y = jnp.zeros((n_t,), jnp.float32)
    t_rel = jnp.asarray(np.linspace(0.0, 10.0, n_t).astype(np.float32))

    a = np.asarray(
        _sample_group_windowed(stack, group, px, py, bs, bs_y, t_rel, static=True)
    )
    b = np.asarray(
        _sample_group_windowed(stack, group, px, py, bs, bs_y, t_rel, static=False)
    )
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_static_hat_sampler_close_on_smooth_screen():
    """With fractional boresight motion, rotation, and wind, the
    static-hat path differs from the scan oracle only by the frac-shift
    kernel composition (two half-cell lerps instead of one bilinear) —
    within a few percent of the sample rms on a beam-smoothed screen,
    the same error class as the spatial bilinear itself. A mixed
    static/scan partition must agree too."""
    from scipy.ndimage import gaussian_filter

    from maria_tpu.atmosphere.sampling import _sample_group_windowed

    rng = np.random.default_rng(9)
    group, ny, nx = _make_static_group(
        [300.0, 2000.0], [8, 16], res=10.0, angle=0.3, vx=1.0, vy=-0.4
    )
    n_det, n_t = 9, 57
    stack = np.stack(
        [gaussian_filter(rng.standard_normal((ny, nx)), 2.0) for _ in range(2)]
    ).astype(np.float32)
    stack = jnp.asarray(stack / stack.std(axis=(1, 2), keepdims=True))
    q = rng.uniform(-8e-3, 8e-3, (n_det, 1))
    qy = rng.uniform(-8e-3, 8e-3, (n_det, 1))
    bs = np.cumsum(rng.uniform(-4e-4, 6e-4, n_t)).astype(np.float32)
    bs_y = np.cumsum(rng.uniform(-5e-4, 4e-4, n_t)).astype(np.float32)
    px = jnp.asarray((q + bs[None, :]).astype(np.float32))
    py = jnp.asarray((qy + bs_y[None, :]).astype(np.float32))
    bs, bs_y = jnp.asarray(bs), jnp.asarray(bs_y)
    t_rel = jnp.asarray(np.linspace(0.0, 20.0, n_t).astype(np.float32))

    args = (stack, group, px, py, bs, bs_y, t_rel)
    oracle = np.asarray(_sample_group_windowed(*args, static=False))
    stat = np.asarray(_sample_group_windowed(*args, static=True))
    # the two paths are linear interpolants with knots shifted by
    # frac(u): each is O(f''/8) from the TRUE field (see the truth test
    # below), so their mutual deviation is bounded by the same class —
    # scale it by the field rms the samples are drawn from, not the
    # (locally small) sample std
    scale = float(np.sqrt((np.asarray(group.pwv_rms) ** 2).sum()))
    assert np.abs(stat - oracle).max() < 0.04 * scale, (
        np.abs(stat - oracle).max(), scale
    )

    group.hat_static = np.array([True, False])
    mixed = np.asarray(_sample_group_windowed(*args, static=True))
    assert np.abs(mixed - oracle).max() < 0.04 * scale


def test_static_hat_sampler_truth_error_matches_oracle_class():
    """On an analytically known band-limited field, the static-hat path's
    error vs the TRUE field must be the same size as the scan oracle's
    own bilinear error — the frac-shifted knots change where the O(f'')
    interpolation error lands, not its magnitude."""
    from maria_tpu.atmosphere.sampling import _sample_group_windowed

    rng = np.random.default_rng(17)
    group, ny, nx = _make_static_group(
        [1500.0], [16], res=10.0, angle=0.25, vx=0.8, vy=-0.3
    )
    n_det, n_t = 13, 61
    # smooth truth: two incommensurate sinusoids, wavelength ~6 cells
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    truth = lambda y, x: np.sin(1.05 * x + 0.3) * np.cos(0.85 * y - 1.1)
    stack = jnp.asarray(truth(yy, xx)[None].astype(np.float32))
    q = rng.uniform(-8e-3, 8e-3, (n_det, 1))
    qy = rng.uniform(-8e-3, 8e-3, (n_det, 1))
    bs = np.cumsum(rng.uniform(-4e-4, 6e-4, n_t)).astype(np.float32)
    bs_y = np.cumsum(rng.uniform(-5e-4, 4e-4, n_t)).astype(np.float32)
    px = jnp.asarray((q + bs[None, :]).astype(np.float32))
    py = jnp.asarray((qy + bs_y[None, :]).astype(np.float32))
    t_rel = jnp.asarray(np.linspace(0.0, 20.0, n_t).astype(np.float32))

    args = (stack, group, px, py, jnp.asarray(bs), jnp.asarray(bs_y), t_rel)
    oracle = np.asarray(_sample_group_windowed(*args, static=False))
    stat = np.asarray(_sample_group_windowed(*args, static=True))

    # true field values at the exact LOS sample positions
    h, res = 1500.0, 10.0
    ca, sa = np.cos(group.angle), np.sin(group.angle)
    rx = ca * np.asarray(px) + sa * np.asarray(py)
    ry = -sa * np.asarray(px) + ca * np.asarray(py)
    dx_t = (ca * group.vx + sa * group.vy) * np.asarray(t_rel)
    dy_t = (-sa * group.vx + ca * group.vy) * np.asarray(t_rel)
    fx = (h * rx + dx_t - group.tx_min) / res
    fy = (h * ry + dy_t - group.ty_min) / res
    want = float(group.pwv_rms[0]) * truth(fy, fx)

    err_oracle = np.abs(oracle - want).max()
    err_static = np.abs(stat - want).max()
    assert err_static < 1.5 * err_oracle + 1e-4, (err_static, err_oracle)


def test_atmosphere_setup_assigns_hat_static():
    """The 3-D fourier setup must flag layers whose detector offsets are
    rigid over the observation for the static-hat GEMM sampler; tol=0
    disables the path."""
    from maria_tpu import get_instrument, get_site
    from maria_tpu.atmosphere.atmosphere import Atmosphere
    from maria_tpu.sim.observation import Observation

    plan = get_plan("ten_second_zenith_stare")
    obs = Observation(
        instrument=get_instrument("test/1deg"), site=get_site("chajnantor"), plan=plan
    )
    atm = Atmosphere(model="3d", region="chajnantor", sampler_dec_tol=0.35)
    atm.initialize(obs)
    g = atm.groups[0]
    assert g.hat_static is not None and len(g.hat_static) == len(g.heights)
    assert g.hat_static.all()  # a short stare: offsets are rigid

    atm0 = Atmosphere(model="3d", region="chajnantor", sampler_dec_tol=0.0)
    atm0.initialize(obs)
    assert not atm0.groups[0].hat_static.any()
