"""Line-of-sight screen sampling — the single numerically authoritative
implementation shared by `Atmosphere.simulate_pwv` and the fused
`TODProgram` (they previously carried divergent copies).

Pure jnp; everything here is called under jit. Geometry convention:
(px, py) are unit-height east/north line-of-sight projections per
(detector, coarse time); a screen at height h is sampled at
x = h*px + vx*t, y = h*py + vy*t, rotated into its extrusion frame by
`angle`. Reference behavior: maria/atmosphere/atmosphere.py:341-366.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.interp import interp_bilinear_uniform, interp_bilinear_windowed
from .fourier import synthesize_layered_matern_2d, synthesize_matern_field_2d

__all__ = ["accumulate_pwv", "gaussian_blur_2d", "sampler_bf16", "sampler_static"]


def sampler_static() -> bool:
    """Whether layers flagged `hat_static` at setup use the static-hat
    GEMM sampler (`_sample_group_static`) instead of the per-sample scan.
    Default ON; MARIA_TPU_SAMPLER_STATIC=0 forces the scan path."""
    import os

    return os.environ.get("MARIA_TPU_SAMPLER_STATIC", "1").lower() not in (
        "0",
        "false",
        "off",
    )


def sampler_bf16() -> bool:
    """Whether the windowed group sampler should run its hat einsums in
    bf16 — a measured NEGATIVE result, default OFF.

    Hypothesis was that the (n_det, chunk, w) hat temporaries' memory
    traffic bound the stage, so bf16 operands would halve it. The stage
    is bound by the elementwise hat CONSTRUCTION (~4 ops x (wx+wy) cells
    x n_samples x n_layers), which no dot-operand precision changes
    (docs/design.md). Kept as an env/arg toggle for re-measurement:
    MARIA_TPU_SAMPLER_BF16=1."""
    import os

    return os.environ.get("MARIA_TPU_SAMPLER_BF16", "").lower() in ("1", "true", "on")


def gaussian_blur_2d(values, sigma_y, sigma_x, res_y, res_x):
    """Periodic FFT Gaussian blur (AR-path analogue of the reference's
    scipy gaussian_filter, maria/atmosphere/atmosphere.py:341-344)."""
    ny, nx = values.shape
    ky = 2 * jnp.pi * jnp.fft.fftfreq(ny, d=res_y)
    kx = 2 * jnp.pi * jnp.fft.rfftfreq(nx, d=res_x)
    G = jnp.exp(-0.5 * (sigma_y**2 * ky[:, None] ** 2 + sigma_x**2 * kx[None, :] ** 2))
    return jnp.fft.irfft2(jnp.fft.rfft2(values) * G, s=(ny, nx))


def _sample_layer(
    values, h, angle, vx, vy, res_x, res_y, tx_min, ty_min,
    win_x, win_y, px, py, bs_px, bs_py, t_rel,
):
    """Sample one screen at the wind-advected LOS points of every
    (detector, coarse-time) sample; windowed MXU path when the static
    window is small relative to the screen."""
    x = h * px + vx * t_rel
    y = h * py + vy * t_rel
    ca, sa = np.cos(angle), np.sin(angle)
    tx = ca * x + sa * y
    ty = -sa * x + ca * y
    ny, nx = values.shape
    windowed = (
        win_x is not None
        and bs_px is not None
        and win_x * win_y <= 0.5 * nx * ny
    )
    if windowed:
        cx_b = ca * (h * bs_px + vx * t_rel) + sa * (h * bs_py + vy * t_rel)
        cy_b = -sa * (h * bs_px + vx * t_rel) + ca * (h * bs_py + vy * t_rel)
        return interp_bilinear_windowed(
            values, tx, ty, cx_b, cy_b, tx_min, res_x, ty_min, res_y, win_x, win_y
        )
    return interp_bilinear_uniform(values, tx, ty, tx_min, res_x, ty_min, res_y)


def accumulate_pwv(
    key, mean_pwv, screens, groups, px, py, bs_px, bs_py, t_rel, ar_values=None
):
    """Zenith-scaled PWV (n_det, n_t) in mm: mean + sum of per-layer
    turbulence samples.

    `screens` are independent per-layer fields: fourier screens carry
    spectral weights `W`; AR screens (W is None) read their extruded
    values from `ar_values[i]` and get beam-blurred here. `groups` are
    vertically-correlated stacks (the 3-D model) synthesized jointly.
    """
    pwv = jnp.full(px.shape, jnp.float32(mean_pwv))
    n_draws = len(screens) + len(groups)
    keys = jax.random.split(key, max(n_draws, 1))

    for i, screen in enumerate(screens):
        ty_res = screen.ty_res if screen.ty_res is not None else screen.res
        if screen.W is not None:
            values = synthesize_matern_field_2d(
                keys[i], jnp.asarray(screen.W), screen.ny, screen.nx
            )
        else:
            if ar_values is None or i not in ar_values:
                raise ValueError("AR screen values missing; run the process first.")
            values = ar_values[i]
            if screen.beam_sigma > 0:
                values = gaussian_blur_2d(
                    values, screen.beam_sigma, screen.beam_sigma, ty_res, screen.res
                )
        sample = _sample_layer(
            values, screen.h, screen.angle, screen.vx, screen.vy,
            screen.res, ty_res, screen.tx_min, screen.ty_min,
            screen.win_x, screen.win_y, px, py, bs_px, bs_py, t_rel,
        )
        pwv = pwv + screen.pwv_rms * sample

    for g, group in enumerate(groups):
        stack = synthesize_layered_matern_2d(
            keys[len(screens) + g],
            jnp.asarray(group.W),
            jnp.asarray(group.M_cos),
            jnp.asarray(group.M_sin),
            None if group.beam is None else jnp.asarray(group.beam),
            group.ny,
            group.nx,
        )
        if group.win_x is not None and bs_px is not None:
            pwv = pwv + _sample_group_windowed(
                stack, group, px, py, bs_px, bs_py, t_rel
            )
        else:
            for il, h in enumerate(group.heights):
                sample = _sample_layer(
                    stack[il], float(h), group.angle, group.vx, group.vy,
                    group.res, group.res, group.tx_min, group.ty_min,
                    None if group.win_x is None else int(group.win_x[il]),
                    None if group.win_y is None else int(group.win_y[il]),
                    px, py, bs_px, bs_py, t_rel,
                )
                pwv = pwv + float(group.pwv_rms[il]) * sample

    return pwv


def _upsample_linear_indices(a, d: int, n_t: int, aligned: bool):
    """Exact linear upsample of (n_det, n_dec) samples taken at fine
    indices 0, d, 2d, ... (plus n_t-1 appended when not aligned) back to
    (n_det, n_t). Pure reshape/broadcast — no gathers."""
    n_det, n_dec = a.shape
    n_uni = n_dec if aligned else n_dec - 1  # count of the arange(0, n_t, d) part
    if n_uni >= 2:
        w = (jnp.arange(d, dtype=a.dtype) / d)[None, None, :]
        main = a[:, : n_uni - 1, None] * (1 - w) + a[:, 1:n_uni, None] * w
        main = main.reshape(n_det, (n_uni - 1) * d)
    else:
        main = jnp.zeros((n_det, 0), a.dtype)
    last_uni = (n_uni - 1) * d  # fine index of the last uniform sample
    if aligned:
        tail = a[:, n_uni - 1 :]
    else:
        m = (n_t - 1) - last_uni  # 1 <= m <= d-1
        tw = (jnp.arange(m + 1, dtype=a.dtype) / m)[None, :]
        tail = a[:, n_uni - 1, None] * (1 - tw) + a[:, n_dec - 1, None] * tw
    return jnp.concatenate([main, tail], axis=1)


def _sample_group_static(stack, group, layer_idxs, qpx, qpy, bs_px, bs_py, t_rel):
    """Static-hat GEMM sampling of the given ScreenGroup layers.

    The scan sampler's bound is the per-(sample, layer) elementwise hat
    CONSTRUCTION (invariant to window size / precision / chunk — see
    `_sample_group_windowed`). But over a TOD the
    detector offsets are nearly RIGID in the screen frame: writing the
    LOS position as fx[d,t] = u[t] + q[d] (boresight track + per-detector
    offset), the offset drift from field rotation and elevation stretch
    is ~1e-3 cells for a 60 s AtLAST scan — far under the 0.35-cell
    tolerance the decimation already accepts. Setup measures the actual
    drift on the hull detectors and flags qualifying layers
    (`Atmosphere initialize` -> group.hat_static).

    For a flagged layer the bilinear sample factors:
      out[d,t] = sum_{j,i} hy[d,j] hx[d,i] * S'[t,j,i]
    where S'[t] is the boresight window shifted by the FRACTIONAL part of
    u[t] (a 4-tap lerp of the (w+1)-cell window — no n_det factor) and
    (hx, hy) are STATIC hats at the detector's window-frame position
    q[d] + w//2. Layers sharing a decimated time grid concatenate along
    the window axis, so each decimation set is ONE MXU GEMM
    (n_det, K) @ (K, n_td) with K = sum_l wy_l*wx_l and the per-layer rms
    folded into H — no per-sample VPU work at all.

    Error class: the static-q approximation is bounded by the measured
    drift (<= sampler_dec_tol cells), and the frac-shift composition
    replaces the bilinear hat with the convolution of two half-cell
    lerps — both are sub-cell interpolation of the beam-smoothed screen,
    the same regime as the spatial bilinear itself. Exact when u lands on
    the grid (uf=0) or q is integer; pinned vs the scan oracle in
    tests/test_atmosphere3d.py.
    """
    heights = np.asarray(group.heights, dtype=np.float64)
    rms = np.asarray(group.pwv_rms, dtype=np.float64)
    ny, nx = group.ny, group.nx
    ca, sa = np.cos(group.angle), np.sin(group.angle)
    inv_res = 1.0 / group.res
    qx = ca * qpx + sa * qpy  # (n_det,) rotated unit-height offsets
    qy = -sa * qpx + ca * qpy
    brx = ca * bs_px + sa * bs_py  # (n_td,) boresight track
    bry = -sa * bs_px + ca * bs_py
    dx_t = (ca * group.vx + sa * group.vy) * t_rel  # (n_td,) wind drift
    dy_t = (-sa * group.vx + ca * group.vy) * t_rel

    # zero-pad the stack so the boresight window NEVER clips: the group
    # grid only carries a 2-cell margin past the detector hull, so a
    # footprint-sized window centered on the boresight can poke past the
    # domain edge at the extreme scan phases. Cells beyond the hull get
    # zero hat weight from every detector (hull + drift + hat support
    # stays >= 0.65 cells inside the domain), so zeros there are exact.
    # The pad is one tiny copy per program (L*ny*nx is ~1 MB at AtLAST
    # scale) — unlike the scan path's clip-and-rebuild, which would
    # misalign the static hats.
    pad_x = max(int(min(np.asarray(group.win_x)[il], nx - 1)) for il in layer_idxs) // 2 + 3
    pad_y = max(int(min(np.asarray(group.win_y)[il], ny - 1)) for il in layer_idxs) // 2 + 3
    stack_p = jnp.pad(stack, ((0, 0), (pad_y, pad_y), (pad_x, pad_x)))

    def _catmull_rom(f):
        # 4-tap Catmull-Rom shift coefficients at fractional offset f:
        # third-order shift error, so the boresight frac-shift does not
        # degrade the hat kernel (a bilinear 2-tap shift composes to a
        # visibly smoother quadratic kernel — measured 14% of sample rms
        # on a sigma=2 screen vs <1% here)
        return (
            -0.5 * f + f**2 - 0.5 * f**3,
            1.0 - 2.5 * f**2 + 1.5 * f**3,
            0.5 * f + 2.0 * f**2 - 1.5 * f**3,
            -0.5 * f**2 + 0.5 * f**3,
        )

    H_parts, S_parts = [], []
    for il in layer_idxs:
        h = np.float32(heights[il])
        wxi = int(min(np.asarray(group.win_x)[il], nx - 1))
        wyi = int(min(np.asarray(group.win_y)[il], ny - 1))
        cx0, cy0 = wxi // 2, wyi // 2
        u = (h * brx + dx_t - group.tx_min) * inv_res  # (n_td,) cells
        v = (h * bry + dy_t - group.ty_min) * inv_res
        u0, v0 = jnp.floor(u), jnp.floor(v)
        # clamp is a safety net only: the pad sizes the domain so the
        # window stays in bounds whenever u tracks the detector hull
        bx = jnp.clip(u0.astype(jnp.int32) - cx0 + pad_x - 1, 0, nx + 2 * pad_x - wxi - 3)
        by = jnp.clip(v0.astype(jnp.int32) - cy0 + pad_y - 1, 0, ny + 2 * pad_y - wyi - 3)
        cxs = _catmull_rom((u - u0)[:, None, None])
        cys = _catmull_rom((v - v0)[:, None, None])
        W = jax.vmap(
            lambda j_, i_: jax.lax.dynamic_slice(stack_p[il], (j_, i_), (wyi + 3, wxi + 3))
        )(by, bx)  # (n_td, wy+3, wx+3)
        Wx = sum(c * W[:, :, n : n + wxi] for n, c in enumerate(cxs))
        S = sum(c * Wx[:, m : m + wyi, :] for m, c in enumerate(cys))
        S_parts.append(S.reshape(S.shape[0], wyi * wxi))
        px_d = h * qx * inv_res + cx0  # (n_det,) window-frame positions
        py_d = h * qy * inv_res + cy0
        kx = jnp.arange(wxi, dtype=stack.dtype)
        ky = jnp.arange(wyi, dtype=stack.dtype)
        hx = jnp.clip(1.0 - jnp.abs(px_d[:, None] - kx), 0.0, 1.0)
        hy = jnp.clip(1.0 - jnp.abs(py_d[:, None] - ky), 0.0, 1.0)
        H_parts.append(
            np.float32(rms[il])
            * (hy[:, :, None] * hx[:, None, :]).reshape(-1, wyi * wxi)
        )
    H = jnp.concatenate(H_parts, axis=1) if len(H_parts) > 1 else H_parts[0]
    S = jnp.concatenate(S_parts, axis=1) if len(S_parts) > 1 else S_parts[0]
    return jnp.einsum("dk,tk->dt", H, S)


def _sample_group_windowed(
    stack, group, px, py, bs_px, bs_py, t_rel,
    chunk: int = None, bf16: bool = None, decimate: bool = True,
    static: bool = None,
):
    """All-layer windowed sampling of a ScreenGroup, accumulating
    sum_l pwv_rms_l * sample_l with per-layer temporal decimation.

    Fusion: the per-layer path materializes ~6 full (n_det, n_t)
    coordinate and transpose buffers per layer (~100 GB of memory
    traffic for 12 AtLAST layers); here the shared rotated projections
    (rx, ry) are built once
    and every per-layer quantity lives on a chunk-local tile inside a
    scan body, so the full-size traffic is one read of rx/ry and one
    write of the accumulated output.

    Decimation: each layer's fused scan-body op costs a fixed amount per
    (sample, layer), invariant to window size, weight form (hats vs
    clamped ramps), bf16 vs f32 and chunk size, so the lever is the
    NUMBER of (sample, layer) evaluations.
    A layer at height h drifts h*d(LOS)/dt + wind per coarse step — at
    AtLAST geometry the lowest layers move ~0.02 cells/step where the
    highest moves ~0.16 — so each layer is sampled on its own
    power-of-2-decimated time grid chosen at setup such that the drift
    per decimated step stays under a fraction of a cell
    (group.dec, see Atmosphere._layer_decimation), then linearly
    upsampled. The interpolation error class is identical to the
    bilinear SPATIAL interpolation the sampler already performs (both
    lerp the beam-smoothed screen over sub-cell distances), so
    decimation adds no new approximation regime. Layers sharing a
    factor d are evaluated in one scan over the decimated grid and one
    upsample pass; d=1 layers keep the original exact path."""
    heights = np.asarray(group.heights, dtype=np.float64)
    n_det, n_t = px.shape
    dec = getattr(group, "dec", None)
    if not decimate or dec is None:
        dec_l = np.ones(len(heights), dtype=int)
    else:
        dec_l = np.minimum(np.asarray(dec, dtype=int), max(n_t - 1, 1))

    hat_static = getattr(group, "hat_static", None)
    use_static = (sampler_static() if static is None else static) and (
        hat_static is not None
    )
    stat_l = (
        np.asarray(hat_static, dtype=bool)
        if use_static
        else np.zeros(len(heights), dtype=bool)
    )
    if stat_l.any():
        # rigid mean detector offsets from boresight (unit height); the
        # setup drift check used the same full-grid mean reference
        qpx = px.mean(-1) - bs_px.mean()
        qpy = py.mean(-1) - bs_py.mean()

    out = None
    for d in sorted(set(dec_l.tolist())):
        idxs = [il for il in range(len(heights)) if dec_l[il] == d]
        s_idxs = [il for il in idxs if stat_l[il]]
        g_idxs = [il for il in idxs if not stat_l[il]]
        if d == 1:
            sl = None
            bs_px_d, bs_py_d, t_rel_d = bs_px, bs_py, t_rel
        else:
            sel = np.arange(0, n_t, d)
            aligned = sel[-1] == n_t - 1
            if not aligned:
                sel = np.append(sel, n_t - 1)
            sl = jnp.asarray(sel)
            bs_px_d = jnp.take(bs_px, sl, axis=-1)
            bs_py_d = jnp.take(bs_py, sl, axis=-1)
            t_rel_d = jnp.take(t_rel, sl, axis=-1)
        part_d = None
        if s_idxs:
            part_d = _sample_group_static(
                stack, group, s_idxs, qpx, qpy, bs_px_d, bs_py_d, t_rel_d
            )
        if g_idxs:
            px_d = px if sl is None else jnp.take(px, sl, axis=-1)
            py_d = py if sl is None else jnp.take(py, sl, axis=-1)
            scan = _sample_group_scan(
                stack, group, g_idxs, px_d, py_d, bs_px_d, bs_py_d, t_rel_d,
                chunk, bf16,
            )
            part_d = scan if part_d is None else part_d + scan
        part = (
            part_d if sl is None else _upsample_linear_indices(part_d, d, n_t, aligned)
        )
        out = part if out is None else out + part
    return out


def _sample_group_scan(
    stack, group, layer_idxs, px, py, bs_px, bs_py, t_rel, chunk=None, bf16=None
):
    """One scan over time chunks evaluating the given layers of a
    ScreenGroup at every (detector, time) sample and accumulating
    sum_l pwv_rms_l * sample_l in-loop. Hat-weight windowed bilinear
    contraction per layer with per-layer static window sizes."""
    bf16 = sampler_bf16() if bf16 is None else bf16
    heights = np.asarray(group.heights, dtype=np.float64)
    rms = np.asarray(group.pwv_rms, dtype=np.float64)
    ny, nx = group.ny, group.nx
    wx_l = {il: int(min(np.asarray(group.win_x)[il], nx)) for il in layer_idxs}
    wy_l = {il: int(min(np.asarray(group.win_y)[il], ny)) for il in layer_idxs}
    wsum = sum(wx_l[il] + wy_l[il] for il in layer_idxs) // max(len(layer_idxs), 1)
    ca, sa = np.cos(group.angle), np.sin(group.angle)
    n_det, n_t = px.shape

    rx = ca * px + sa * py  # (n_det, n_t) rotated unit-height projections
    ry = -sa * px + ca * py
    brx = ca * bs_px + sa * bs_py  # (n_t,) boresight track
    bry = -sa * bs_px + ca * bs_py
    dx_t = (ca * group.vx + sa * group.vy) * t_rel  # (n_t,) wind drift
    dy_t = (-sa * group.vx + ca * group.vy) * t_rel

    if chunk is None:
        # weight tiles: n_det * chunk * mean(wx + wy) f32 <= ~256 MB. The
        # layer loop is unrolled SEQUENTIALLY inside the body, so only
        # one layer's tiles are live at a time — no L factor
        budget = (1 << 26) // max(n_det * wsum, 1)
        chunk = int(np.clip(budget, 1, n_t))
    n_chunks = -(-n_t // chunk)
    pad = n_chunks * chunk - n_t

    def pad_t(a, fill):
        cfg = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return jnp.pad(a, cfg, constant_values=fill) if pad else a

    # padded samples get off-window coords -> zero hat weight
    rx_p, ry_p = pad_t(rx, 1e30), pad_t(ry, 1e30)
    brx_p, bry_p = pad_t(brx, 0.0), pad_t(bry, 0.0)
    dxt_p, dyt_p = pad_t(dx_t, 0.0), pad_t(dy_t, 0.0)

    inv_res = 1.0 / group.res

    def body(_, i):
        t0 = i * chunk
        sl2 = lambda a: jax.lax.dynamic_slice_in_dim(a, t0, chunk, axis=-1)
        rx_c, ry_c = sl2(rx_p), sl2(ry_p)  # (n_det, chunk)
        brx_c, bry_c = sl2(brx_p), sl2(bry_p)  # (chunk,)
        dx_c, dy_c = sl2(dxt_p), sl2(dyt_p)
        out_c = jnp.zeros((n_det, chunk), dtype=stack.dtype)
        for il in layer_idxs:
            h = np.float32(heights[il])
            wxi, wyi = wx_l[il], wy_l[il]
            kx = jnp.arange(wxi, dtype=stack.dtype)
            ky = jnp.arange(wyi, dtype=stack.dtype)
            fx = (h * rx_c + dx_c - group.tx_min) * inv_res  # (n_det, chunk)
            fy = (h * ry_c + dy_c - group.ty_min) * inv_res
            cx = (h * brx_c + dx_c - group.tx_min) * inv_res  # (chunk,)
            cy = (h * bry_c + dy_c - group.ty_min) * inv_res
            ix0 = jnp.clip(jnp.round(cx).astype(jnp.int32) - wxi // 2, 0, nx - wxi)
            iy0 = jnp.clip(jnp.round(cy).astype(jnp.int32) - wyi // 2, 0, ny - wyi)
            wins = jax.vmap(
                lambda i_, j_: jax.lax.dynamic_slice(stack[il], (i_, j_), (wyi, wxi))
            )(iy0, ix0)  # (chunk, wy, wx)
            w_x = jnp.clip(1.0 - jnp.abs(fx[..., None] - ix0[:, None] - kx), 0.0, 1.0)
            w_y = jnp.clip(1.0 - jnp.abs(fy[..., None] - iy0[:, None] - ky), 0.0, 1.0)
            if bf16:
                # bf16 hats/windows halve the dominant (n_det, chunk, w)
                # memory traffic; f32 accumulate. The scan body is bound
                # by the fixed per-sample fusion cost — kept opt-in.
                tmp = jnp.einsum(
                    "tyx,dtx->dty",
                    wins.astype(jnp.bfloat16),
                    w_x.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32,
                )
            else:
                tmp = jnp.einsum("tyx,dtx->dty", wins, w_x)
            out_c = out_c + np.float32(rms[il]) * (tmp * w_y).sum(-1)
        return None, out_c

    _, chunks = jax.lax.scan(body, None, jnp.arange(n_chunks))
    out = jnp.moveaxis(chunks, 0, 1).reshape(n_det, n_chunks * chunk)
    return out[:, :n_t]
