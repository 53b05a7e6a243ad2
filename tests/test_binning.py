"""Windowed MXU binning vs the scatter reference
(reference behavior: maria/mappers/bin_mapper.py:100-112)."""

import jax
import jax.numpy as jnp
import numpy as np

from maria_tpu.ops.binning import bin_scatter, bin_windowed, make_windowed_bin_plan


def _daisy_pixels(n_det=50, n_t=700, n_map=96, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    t = np.arange(n_t) / 50.0
    cx = n_map / 2 + 28 * np.sin(2 * np.pi * t / 20) * np.cos(2 * np.pi * t / 6)
    cy = n_map / 2 + 28 * np.sin(2 * np.pi * t / 20) * np.sin(2 * np.pi * t / 6)
    ix = np.clip((cx[None] + rng.uniform(-4, 4, n_det)[:, None]).astype(np.int32), 0, n_map - 1)
    iy = np.clip((cy[None] + rng.uniform(-4, 4, n_det)[:, None]).astype(np.int32), 0, n_map - 1)
    return iy, ix, n_map


def test_windowed_matches_scatter():
    iy, ix, n_map = _daisy_pixels()
    plan = make_windowed_bin_plan(iy, ix, n_map, n_map, chunk=64)
    assert plan is not None

    rng = np.random.default_rng(1)
    data = rng.standard_normal(iy.shape).astype(np.float32)
    m_w = np.asarray(jax.jit(lambda d: bin_windowed(d, plan))(jnp.asarray(data)))
    pix = jnp.asarray((iy.astype(np.int64) * n_map + ix).ravel().astype(np.int32))
    m_s = np.asarray(bin_scatter(jnp.asarray(data), pix, n_map * n_map)).reshape(n_map, n_map)
    np.testing.assert_allclose(m_w, m_s, atol=1e-4 * max(1.0, np.abs(m_s).max()))


def test_windowed_with_weights():
    iy, ix, n_map = _daisy_pixels(rng_seed=3)
    plan = make_windowed_bin_plan(iy, ix, n_map, n_map, chunk=64)
    rng = np.random.default_rng(2)
    data = rng.standard_normal(iy.shape).astype(np.float32)
    w = rng.uniform(0.5, 2.0, iy.shape).astype(np.float32)
    m_w = np.asarray(bin_windowed(jnp.asarray(data), plan, weights=jnp.asarray(w)))
    pix = jnp.asarray((iy.astype(np.int64) * n_map + ix).ravel().astype(np.int32))
    m_s = np.asarray(bin_scatter(jnp.asarray(data), pix, n_map * n_map, weights=jnp.asarray(w)))
    np.testing.assert_allclose(m_w, m_s.reshape(n_map, n_map), atol=1e-4 * max(1.0, np.abs(m_s).max()))


def test_plan_falls_back_when_windows_cover_map():
    """Wide-field pointing (windows ~ whole map) must return None so
    callers use the scatter path."""
    rng = np.random.default_rng(0)
    iy = rng.integers(0, 64, size=(40, 512)).astype(np.int32)
    ix = rng.integers(0, 64, size=(40, 512)).astype(np.int32)
    assert make_windowed_bin_plan(iy, ix, 64, 64, chunk=64) is None


def test_off_map_samples_are_dropped():
    iy, ix, n_map = _daisy_pixels(n_det=10, n_t=128)
    iy = iy.copy()
    iy[0, :] = -1  # mark detector 0 off-map
    plan = make_windowed_bin_plan(iy, ix, n_map, n_map, chunk=64)
    data = np.ones(iy.shape, dtype=np.float32)
    m = np.asarray(bin_windowed(jnp.asarray(data), plan))
    assert m.sum() == (iy.shape[0] - 1) * iy.shape[1]


def test_runlength_matches_scatter():
    from maria_tpu.ops.binning import bin_runlength, make_runlength_bin_plan

    rng = np.random.default_rng(5)
    n_det, n_t, n_pix = 25, 400, 150
    pix = (np.cumsum(rng.integers(0, 2, size=(n_det, n_t)), axis=-1) + rng.integers(0, 50, (n_det, 1))) % n_pix
    plan = make_runlength_bin_plan(pix, n_pix)
    assert len(plan.starts) < pix.size  # actually compressed
    data = rng.standard_normal((n_det, n_t)).astype(np.float32)
    m_rl = np.asarray(
        bin_runlength(
            jnp.asarray(data), jnp.asarray(plan.starts), jnp.asarray(plan.ends),
            jnp.asarray(plan.run_pix), n_pix,
        )
    )
    m_s = np.asarray(bin_scatter(jnp.asarray(data), jnp.asarray(pix.astype(np.int32)), n_pix))
    np.testing.assert_allclose(m_rl, m_s, atol=1e-4 * max(1.0, np.abs(m_s).max()))


def _widefield_pixels(n_det=600, n_t=300, n_map=128, rng_seed=5):
    """Wide-field: detector footprint covers most of the map (the case
    where per-time-chunk windows fail but det-blocked windows work)."""
    rng = np.random.default_rng(rng_seed)
    # detectors spread across ~80% of the map, slow boresight drift
    det_y = rng.uniform(0.1, 0.9, n_det) * n_map
    det_x = rng.uniform(0.1, 0.9, n_det) * n_map
    t = np.arange(n_t) / 50.0
    cy = 6 * np.sin(2 * np.pi * t / 30)
    cx = 6 * np.cos(2 * np.pi * t / 30)
    iy = np.clip((det_y[:, None] + cy[None]).astype(np.int32), -1, n_map - 1)
    ix = np.clip((det_x[:, None] + cx[None]).astype(np.int32), -1, n_map - 1)
    return iy, ix, n_map


def test_blocked_matches_scatter_widefield():
    from maria_tpu.ops.binning import bin_blocked, make_blocked_bin_plan

    iy, ix, n_map = _widefield_pixels()
    # the time-chunk-only plan must refuse this geometry...
    assert make_windowed_bin_plan(iy, ix, n_map, n_map) is None
    # ...while the det-blocked plan handles it
    plan = make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=32, det_block=64)
    assert plan is not None
    assert plan.wy * plan.wx < 0.5 * n_map * n_map

    rng = np.random.default_rng(7)
    data = rng.standard_normal(iy.shape).astype(np.float32)
    m_b = np.asarray(jax.jit(lambda d: bin_blocked(d, plan))(jnp.asarray(data)))
    pix = jnp.asarray((iy.astype(np.int64) * n_map + ix).ravel().astype(np.int32))
    m_s = np.asarray(bin_scatter(jnp.asarray(data), pix, n_map * n_map)).reshape(n_map, n_map)
    np.testing.assert_allclose(m_b, m_s, atol=1e-4 * max(1.0, np.abs(m_s).max()))


def test_device_plan_matches_host_plan():
    """make_blocked_bin_plan_on_device must reproduce the host plan
    exactly (same windows, origins, local offsets, order) and bin to
    the same map — it is the path the AtLAST-scale bench uses."""
    from maria_tpu.ops.binning import (
        bin_blocked,
        make_blocked_bin_plan,
        make_blocked_bin_plan_on_device,
    )

    iy, ix, n_map = _widefield_pixels(rng_seed=23)
    iy[::9, 4:9] = -1  # off-map samples
    ix[::9, 4:9] = -1
    host = make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=32, det_block=64)
    dev = make_blocked_bin_plan_on_device(
        jnp.asarray(iy), jnp.asarray(ix), n_map, n_map, chunk=32, det_block=64
    )
    assert (host is None) == (dev is None)
    assert (dev.wy, dev.wx) == (host.wy, host.wx)
    np.testing.assert_array_equal(dev.order, host.order)
    np.testing.assert_array_equal(dev.origins, host.origins)
    np.testing.assert_array_equal(np.asarray(dev.ly), host.ly)
    np.testing.assert_array_equal(np.asarray(dev.lx), host.lx)

    rng = np.random.default_rng(3)
    data = jnp.asarray(rng.standard_normal(iy.shape).astype(np.float32))
    m_h = np.asarray(bin_blocked(data, host))
    m_d = np.asarray(bin_blocked(data, dev, *(), ly=dev.ly, lx=dev.lx))
    np.testing.assert_array_equal(m_h, m_d)


def test_blocked_channels_weights_and_offmap():
    from maria_tpu.ops.binning import bin_blocked, make_blocked_bin_plan

    iy, ix, n_map = _widefield_pixels(rng_seed=11)
    # mark a stripe of samples off-map; they must be dropped
    iy[::7, 10:20] = -1
    ix[::7, 10:20] = -1
    plan = make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=32, det_block=64)
    rng = np.random.default_rng(13)
    data = rng.standard_normal((3, *iy.shape)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, iy.shape).astype(np.float32)

    m_b = np.asarray(bin_blocked(jnp.asarray(data), plan, weights=jnp.asarray(w)[None]))
    assert m_b.shape == (3, n_map, n_map)
    good = iy.ravel() >= 0
    pix = (iy.astype(np.int64) * n_map + ix).ravel()[good].astype(np.int32)
    for ch in range(3):
        ref = np.zeros(n_map * n_map, dtype=np.float64)
        np.add.at(ref, pix, (data[ch] * w).ravel()[good])
        np.testing.assert_allclose(
            m_b[ch].ravel(), ref, atol=1e-4 * max(1.0, np.abs(ref).max())
        )


def test_blocked_matches_scatter_on_narrow_field():
    """Blocked plan also subsumes the narrow-field (MUSTANG-2-like) case."""
    from maria_tpu.ops.binning import bin_blocked, make_blocked_bin_plan

    iy, ix, n_map = _daisy_pixels(rng_seed=17)
    plan = make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=32, det_block=256)
    assert plan is not None
    rng = np.random.default_rng(19)
    data = rng.standard_normal(iy.shape).astype(np.float32)
    m_b = np.asarray(bin_blocked(jnp.asarray(data), plan))
    pix = jnp.asarray((iy.astype(np.int64) * n_map + ix).ravel().astype(np.int32))
    m_s = np.asarray(bin_scatter(jnp.asarray(data), pix, n_map * n_map)).reshape(n_map, n_map)
    np.testing.assert_allclose(m_b, m_s, atol=1e-4 * max(1.0, np.abs(m_s).max()))


def test_blocked_window_not_inflated_by_single_axis_offmap():
    """A sample marked off-map in only ONE axis (legal per the plan
    contract) must not drag that pair's window origin to -1 and inflate
    the global window."""
    from maria_tpu.ops.binning import bin_blocked, make_blocked_bin_plan

    n_map = 512
    rng = np.random.default_rng(23)
    iy = rng.integers(200, 220, (64, 128)).astype(np.int32)
    ix = rng.integers(460, 480, (64, 128)).astype(np.int32)
    ix[3, 7] = -1  # off-map in x only
    plan = make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=32, det_block=64)
    assert plan is not None
    assert plan.wx <= 32  # not inflated to span from x=0

    data = rng.standard_normal(iy.shape).astype(np.float32)
    m = np.asarray(bin_blocked(jnp.asarray(data), plan))
    good = (iy.ravel() >= 0) & (ix.ravel() >= 0)
    ref = np.zeros(n_map * n_map)
    np.add.at(ref, (iy.astype(np.int64) * n_map + ix).ravel()[good], data.ravel()[good])
    np.testing.assert_allclose(m.ravel(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_blocked_hilo_precision_matches_f64():
    """precision='hilo' (bf16 one-hot hats + hi/lo split data, two MXU
    passes) must track the f64 scatter sum at least as tightly as the
    default 3-pass HIGH path: the hats and both data halves are
    bf16-exact, so the only rounding is the ~1e-7-relative split."""
    from maria_tpu.ops.binning import bin_blocked, make_blocked_bin_plan

    iy, ix, n_map = _widefield_pixels()
    plan = make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=32, det_block=64)
    rng = np.random.default_rng(11)
    data = rng.standard_normal(iy.shape).astype(np.float32) * 100.0

    m64 = np.zeros((n_map, n_map))
    np.add.at(m64, (iy.ravel(), ix.ravel()), data.ravel().astype(np.float64))

    scale = np.abs(m64).max()
    for prec in ("hilo", None):
        m = np.asarray(
            jax.jit(lambda d, p=prec: bin_blocked(d, plan, precision=p))(
                jnp.asarray(data)
            )
        )
        np.testing.assert_allclose(m, m64, atol=3e-5 * scale)


def test_blocked_shifted_precision():
    """precision='shifted' (ONE bf16 pass of [mean-shifted data; ones]
    with the mean restored through the valid-hit-count window) tracks
    the f64 scatter to the in-chunk-fluctuation bf16 bound, including a
    large common-mode offset that plain bf16 would destroy; a ones
    channel comes back as EXACT hit counts."""
    from maria_tpu.ops.binning import bin_blocked, make_blocked_bin_plan

    iy, ix, n_map = _widefield_pixels()
    plan = make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=32, det_block=64)
    rng = np.random.default_rng(12)
    # big offset + small fluctuations: the regime the shift exists for
    data = (1000.0 + rng.standard_normal(iy.shape)).astype(np.float32)
    channels = jnp.stack([jnp.asarray(data), jnp.ones_like(jnp.asarray(data))])

    m64 = np.zeros((n_map, n_map))
    np.add.at(m64, (iy.ravel(), ix.ravel()), data.ravel().astype(np.float64))
    cnt = np.zeros((n_map, n_map))
    np.add.at(cnt, (iy.ravel(), ix.ravel()), 1.0)

    m = np.asarray(
        jax.jit(lambda d: bin_blocked(d, plan, precision="shifted"))(channels)
    )
    # sums: error ~ 2^-9 of the per-sample fluctuation, not of the offset
    hits = np.maximum(cnt, 1.0)
    np.testing.assert_allclose(m[0] / hits, m64 / hits, atol=2e-2)
    # hit counts are exact (ones have zero residual after the shift)
    np.testing.assert_array_equal(m[1], cnt)
