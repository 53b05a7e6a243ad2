"""Regular-grid interpolation in pure jnp.

Replaces jax.scipy's RegularGridInterpolator objects in the reference's
hot paths (maria/spectrum/atmosphere.py:92, band/band.py:283) with a
closed-form multilinear gather that fuses into surrounding XLA programs:
grid coordinates -> fractional indices -> 2^d corner gathers with
bilinear weights. All shapes static; safe under jit/vmap/shard_map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "interp_1d",
    "RegularGridInterpolator",
    "interp_bilinear_grid",
    "make_table_eval",
    "fit_chebyshev_2d",
    "eval_chebyshev_2d",
]


def _axis_transform(side):
    """Classify a grid axis: ('uniform', x0, dx) | ('log', logx0, dlog) |
    ('general', side). Uniform and log-uniform axes index arithmetically —
    searchsorted is a binary search whose every step is a gather, so
    avoiding it matters on the hot path."""
    side = np.asarray(side, dtype=np.float64)
    d = np.diff(side)
    if len(d) == 0:
        return ("uniform", float(side[0]), 1.0)
    if np.ptp(d) <= 1e-5 * np.abs(d).mean():
        return ("uniform", float(side[0]), float(d.mean()))
    if (side > 0).all():
        ld = np.diff(np.log(side))
        if np.ptp(ld) <= 1e-5 * np.abs(ld).mean():
            return ("log", float(np.log(side[0])), float(ld.mean()))
    return ("general", side)


def _fractional_index_transformed(transform, x):
    kind = transform[0]
    if kind == "uniform":
        _, x0, dx = transform
        return (x - x0) / dx
    if kind == "log":
        _, lx0, dl = transform
        return (jnp.log(x) - lx0) / dl
    side = jnp.asarray(transform[1])
    n = side.shape[0]
    i = jnp.clip(jnp.searchsorted(side, x, side="right") - 1, 0, n - 2)
    return i + (x - side[i]) / (side[i + 1] - side[i])


def _fractional_index(side, x):
    """Fractional index of x on the (ascending) grid `side`, clipped to the domain."""
    side = jnp.asarray(side)
    n = side.shape[0]
    i = jnp.clip(jnp.searchsorted(side, x, side="right") - 1, 0, n - 2)
    return i + (x - side[i]) / (side[i + 1] - side[i])


def interp_1d(x, side, values, axis=-1):
    """Linear interpolation of `values` along `axis` at points x (clipped)."""
    values = jnp.asarray(values)
    axis = axis % values.ndim
    f = jnp.clip(_fractional_index(side, x), 0.0, values.shape[axis] - 1.0)
    lo = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, values.shape[axis] - 2)
    w = (f - lo)[(...,) + (None,) * (values.ndim - 1 - axis)]
    v_lo = jnp.take(values, lo, axis=axis)
    v_hi = jnp.take(values, lo + 1, axis=axis)
    return v_lo * (1 - w) + v_hi * w


class RegularGridInterpolator:
    """Multilinear interpolation on a d-dimensional regular grid.

    `points` is a tuple of d ascending 1-D arrays; `values` has shape
    (*[len(p) for p in points], *trailing). Evaluation clips to the domain
    (constant extrapolation). The call is pure jnp and can be jitted with
    the instance closed over as a constant.
    """

    def __init__(self, points, values):
        self.points = tuple(jnp.asarray(p) for p in points)
        self._transforms = tuple(_axis_transform(np.asarray(p)) for p in points)
        self.values = jnp.asarray(values)
        self.ndim = len(self.points)
        grid_shape = tuple(len(p) for p in self.points)
        if self.values.shape[: self.ndim] != grid_shape:
            raise ValueError(
                f"values shape {self.values.shape} does not start with grid shape {grid_shape}",
            )
        # flatten the grid dims for a single gather
        self._strides = np.cumprod((1,) + grid_shape[::-1][:-1])[::-1].tolist()
        self._flat = self.values.reshape((-1,) + self.values.shape[self.ndim:])

    def __call__(self, xi):
        """xi: tuple of d broadcastable coordinate arrays."""
        if not isinstance(xi, (tuple, list)):
            xi = (xi,)
        if len(xi) != self.ndim:
            raise ValueError(f"expected {self.ndim} coordinate arrays, got {len(xi)}")
        xi = jnp.broadcast_arrays(*[jnp.asarray(x) for x in xi])

        los, weights = [], []
        for d, x in enumerate(xi):
            side = self.points[d]
            f = jnp.clip(
                _fractional_index_transformed(self._transforms[d], x), 0.0, side.shape[0] - 1.0
            )
            lo = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, side.shape[0] - 2)
            los.append(lo)
            weights.append(f - lo)

        out = 0.0
        for corner in range(1 << self.ndim):
            idx = 0
            w = 1.0
            for d in range(self.ndim):
                hi = (corner >> d) & 1
                idx = idx + (los[d] + hi) * self._strides[d]
                w = w * jnp.where(hi, weights[d], 1 - weights[d])
            vals = jnp.take(self._flat, idx.reshape(-1), axis=0).reshape(
                idx.shape + self._flat.shape[1:]
            )
            out = out + vals * w.reshape(w.shape + (1,) * (self._flat.ndim - 1))
        return out


def _phase_stencil_matrix(ratio: int, kind: str) -> np.ndarray:
    """Static (taps, ratio) phase-stencil weights shared by the full
    upsample and the streaming executor's blockwise variants (they must
    be bitwise-identical)."""
    s = np.arange(ratio, dtype=np.float64) / ratio
    if kind == "linear":
        return np.stack([1 - s, s])
    return 0.5 * np.stack(
        [
            -s + 2 * s**2 - s**3,
            2 - 5 * s**2 + 3 * s**3,
            s + 4 * s**2 - 3 * s**3,
            -(s**2) + s**3,
        ]
    )


def phase_major_cells(taps, C, dtype):
    """Shared phase-major stencil contraction: out[..., c, r] =
    sum_k C[k, r] * taps[k][..., c], stacked on a new minor axis. The
    single source for the full upsample AND the streaming executor's
    blockwise variants, so they stay BITWISE equal (same scalar
    constants, same summation order)."""
    C = np.asarray(C, dtype=np.float64)
    cols = [
        sum(jnp.asarray(C[k, r], dtype=dtype) * taps[k] for k in range(len(taps)))
        for r in range(C.shape[1])
    ]
    return jnp.stack(cols, axis=-1)


def upsample_time_phases(values, ratio: int, n_fine: int, kind: str = "cubic"):
    """Gather-free upsample for an INTEGER coarse/fine ratio.

    Fine sample j = c * ratio + r interpolates coarse samples around c
    with weights depending only on the phase r — so the whole upsample is
    `ratio` shifted stencil multiplies (elementwise work, no gather).
    This is the path the fused program uses; `upsample_time` handles
    arbitrary grids.
    """
    values = jnp.asarray(values)
    n_c = values.shape[-1]

    # The stencil is a STATIC (taps, ratio) matrix. Phase-MAJOR
    # evaluation: each phase r is a `taps`-term scalar-weighted sum of
    # the shifted coarse views, stacked on a new minor axis — elementwise
    # work whose only materialization is the output. An einsum
    # ("k...c,kr->...cr") would be a K=taps, N=ratio dot_general that a
    # matrix unit pads to its tile width; a broadcast form would
    # materialize a (..., n_c-1, taps, ratio) temp that does not fit at
    # AtLAST scale — the per-phase sums here keep temps coarse-sized.
    if kind == "linear" or n_c < 4:
        taps = [values[..., :-1], values[..., 1:]]
        C = _phase_stencil_matrix(ratio, "linear")
    else:
        # Catmull-Rom on interior cells; clamp the edge cells
        pad = jnp.concatenate([values[..., :1], values, values[..., -1:]], axis=-1)
        taps = [pad[..., :-3], pad[..., 1:-2], pad[..., 2:-1], pad[..., 3:]]
        C = _phase_stencil_matrix(ratio, "cubic")
    out = phase_major_cells(taps, C, values.dtype)
    out = out.reshape(*values.shape[:-1], (n_c - 1) * ratio)
    # extend with the last coarse value to n_fine
    deficit = n_fine - out.shape[-1]
    if deficit > 0:
        tail = jnp.repeat(values[..., -1:], deficit, axis=-1)
        out = jnp.concatenate([out, tail], axis=-1)
    return out[..., :n_fine]


def upsample_time(values, t_coarse, t_fine, kind: str = "cubic"):
    """Upsample (..., n_coarse) arrays from a uniform coarse time grid to
    fine times, with linear or Catmull-Rom cubic interpolation (the
    reference uses scipy interp1d linear/cubic, maria/sim/atmosphere.py:30-37,72-80).
    Extrapolation is clamped to the end values."""
    values = jnp.asarray(values)
    n = values.shape[-1]
    t0 = t_coarse[0]
    dt = (t_coarse[-1] - t_coarse[0]) / max(n - 1, 1)
    f = (jnp.asarray(t_fine) - t0) / dt
    if kind == "linear" or n < 4:
        i = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, n - 2)
        w = jnp.clip(f - i, 0.0, 1.0)
        return values[..., i] * (1 - w) + values[..., i + 1] * w
    # Catmull-Rom cubic
    i = jnp.clip(jnp.floor(f).astype(jnp.int32), 1, n - 3)
    s = jnp.clip(f - i, 0.0, 1.0)
    p0, p1, p2, p3 = (values[..., i - 1], values[..., i], values[..., i + 1], values[..., i + 2])
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * s
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * s**2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * s**3
    )


def interp_bilinear_uniform(values, x, y, x0, dx, y0, dy, fill_value=0.0):
    """Bilinear sample of a 2-D field (ny, nx) on a UNIFORM grid: indices
    are pure arithmetic (no searchsorted), leaving only the 4 corner
    gathers — the hot-path variant used inside the fused program."""
    values = jnp.asarray(values)
    ny, nx = values.shape
    fx = (x - x0) / dx
    fy = (y - y0) / dy
    inside = (fx >= 0) & (fx <= nx - 1) & (fy >= 0) & (fy <= ny - 1)
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
    wx, wy = fx - ix, fy - iy
    flat = values.ravel()
    base = iy * nx + ix
    v00 = jnp.take(flat, base)
    v01 = jnp.take(flat, base + 1)
    v10 = jnp.take(flat, base + nx)
    v11 = jnp.take(flat, base + nx + 1)
    out = (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )
    return jnp.where(inside, out, fill_value)


def interp_bilinear_windowed(values, tx, ty, cx, cy, x0, dx, y0, dy, wx: int, wy: int, chunk: int = None):
    """Windowed bilinear sampling: gather-free, matmul-formulated.

    At each (coarse) time step all detectors fall inside a small window
    of the screen around the boresight track (cx, cy). The window is cut
    with a contiguous dynamic_slice (unlike scattered gathers), and the
    bilinear interpolation becomes two small dense
    contractions with hat-function weight matrices:

        out[d] = w_y[d] @ W @ w_x[d]   (W the (wy, wx) window)

    Points outside the window get zero weight, matching the
    fill_value=0 semantics of interp_bilinear_uniform.

    Dead end: rewriting the hats as clamped ramps contracted with a
    second-differenced window (fewer elementwise ops per weight cell,
    exactly equal output) made this path slower; the per-layer scan-body
    fusions cost a fixed amount per (sample, layer) regardless of window
    size, weight form, precision, or chunk, so only reducing the number
    of (sample, layer) evaluations helps (see the per-layer temporal
    decimation in atmosphere/sampling.py).

    values: (ny, nx); tx/ty: (n_det, n_t); cx/cy: (n_t,). wx/wy are
    static window sizes in cells. Work is chunked over time to bound the
    (n_det, chunk, w) weight intermediates.
    """
    values = jnp.asarray(values)
    ny, nx = values.shape
    n_det, n_t = tx.shape

    wx = int(min(wx, nx))
    wy = int(min(wy, ny))

    ix0 = jnp.clip(jnp.round((cx - x0) / dx).astype(jnp.int32) - wx // 2, 0, nx - wx)
    iy0 = jnp.clip(jnp.round((cy - y0) / dy).astype(jnp.int32) - wy // 2, 0, ny - wy)

    fx = (tx - x0) / dx - ix0[None, :]  # local fractional coords (n_det, n_t)
    fy = (ty - y0) / dy - iy0[None, :]

    if chunk is None:
        # bound the weight intermediates to ~256 MB: a scan step has a
        # fixed overhead, so fewer, fatter steps win; 256 MB of f32
        # weights is comfortably within device-memory headroom
        chunk = max(1, min(n_t, (1 << 26) // max(n_det * (wx + wy), 1)))
    n_chunks = -(-n_t // chunk)
    pad = n_chunks * chunk - n_t

    def pad_t(a, fill=0.0):
        return jnp.pad(a, ((0, 0), (0, pad)), constant_values=fill) if a.ndim == 2 else jnp.pad(a, (0, pad))

    fx_c = pad_t(fx, -2.0).reshape(n_det, n_chunks, chunk)
    fy_c = pad_t(fy, -2.0).reshape(n_det, n_chunks, chunk)
    ix0_c = pad_t(ix0).reshape(n_chunks, chunk)
    iy0_c = pad_t(iy0).reshape(n_chunks, chunk)

    kx = jnp.arange(wx, dtype=values.dtype)
    ky = jnp.arange(wy, dtype=values.dtype)

    def body(_, args):
        fx_b, fy_b, ix0_b, iy0_b = args  # (n_det, chunk), (chunk,)
        windows = jax.vmap(
            lambda i, j: jax.lax.dynamic_slice(values, (i, j), (wy, wx))
        )(iy0_b, ix0_b)  # (chunk, wy, wx)
        w_x = jnp.clip(1.0 - jnp.abs(fx_b[..., None] - kx), 0.0, 1.0)  # (n_det, chunk, wx)
        w_y = jnp.clip(1.0 - jnp.abs(fy_b[..., None] - ky), 0.0, 1.0)  # (n_det, chunk, wy)
        tmp = jnp.einsum("tyx,dtx->dty", windows, w_x)  # (n_det, chunk, wy)
        out = (tmp * w_y).sum(-1)  # (n_det, chunk)
        return None, out

    _, chunks = jax.lax.scan(
        body, None,
        (
            jnp.moveaxis(fx_c, 1, 0), jnp.moveaxis(fy_c, 1, 0),
            ix0_c, iy0_c,
        ),
    )  # (n_chunks, n_det, chunk)
    out = jnp.moveaxis(chunks, 0, 1).reshape(n_det, n_chunks * chunk)
    return out[:, :n_t]


def interp_bilinear_grid(values, x, y, x_side, y_side, fill_value=0.0):
    """Bilinear sample of a 2-D field `values` (ny, nx) at points (x, y).

    Out-of-domain points get `fill_value`. Used by the turbulence
    line-of-sight sampler. Grid axes are classified once (uniform axes
    index arithmetically, no searchsorted).
    """
    values = jnp.asarray(values)
    fx = _fractional_index_transformed(_axis_transform(np.asarray(x_side)), x)
    fy = _fractional_index_transformed(_axis_transform(np.asarray(y_side)), y)
    inside = (
        (x >= x_side[0]) & (x <= x_side[-1]) & (y >= y_side[0]) & (y <= y_side[-1])
    )
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, values.shape[1] - 2)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, values.shape[0] - 2)
    wx, wy = fx - ix, fy - iy
    v00 = values[iy, ix]
    v01 = values[iy, ix + 1]
    v10 = values[iy + 1, ix]
    v11 = values[iy + 1, ix + 1]
    out = (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )
    return jnp.where(inside, out, fill_value)


# -- gather-free table evaluation -------------------------------------------------
#
# Bilinear lookups of tiny smooth (pwv, el) tables at 10^7-10^8 sample
# points are gather-bound. The hot path is `make_table_eval` below — an
# EXACT
# clamped-ramp reformulation of bilinear interpolation with zero
# gathers. The Chebyshev pair is a general-purpose smooth-surface
# alternative for non-tabular use.


def fit_chebyshev_2d(x_side, y_side, table, deg_x: int = 12, deg_y: int = 8, log_x: bool = None):
    """Host: least-squares tensor-product Chebyshev fit of a 2-D table.

    Returns a dict with the coefficient matrix, domain normalization and
    the fit's max relative error (callers fall back to bilinear gathers
    when the table isn't smooth enough)."""
    x = np.asarray(x_side, dtype=np.float64)
    y = np.asarray(y_side, dtype=np.float64)
    if log_x is None:  # geometric grids fit better in log
        log_x = bool((x > 0).all() and np.ptp(np.diff(np.log(x))) < 1e-5 * np.abs(np.diff(np.log(x))).mean())
    lx = np.log(x) if log_x else x
    ux = 2 * (lx - lx[0]) / (lx[-1] - lx[0]) - 1
    uy = 2 * (y - y[0]) / (y[-1] - y[0]) - 1
    Tx = np.polynomial.chebyshev.chebvander(ux, deg_x)
    Ty = np.polynomial.chebyshev.chebvander(uy, deg_y)
    A = np.einsum("ik,jl->ijkl", Tx, Ty).reshape(len(x) * len(y), -1)
    tab = np.asarray(table, dtype=np.float64)
    coef, *_ = np.linalg.lstsq(A, tab.ravel(), rcond=None)
    fit = (A @ coef).reshape(tab.shape)
    scale = max(np.abs(tab).max(), 1e-30)
    return {
        "coeffs": coef.reshape(deg_x + 1, deg_y + 1).astype(np.float32),
        "x0": float(lx[0]), "x1": float(lx[-1]),
        "y0": float(y[0]), "y1": float(y[-1]),
        "log_x": bool(log_x),
        "max_rel_err": float(np.abs(fit - tab).max() / scale),
    }


def eval_chebyshev_2d(fit: dict, x, y):
    """Device: evaluate the fitted surface at (x, y) — pure flops, O(1)
    memory via rolling Chebyshev recurrences (no (deg+1)-sized stacks of
    point-shaped arrays)."""
    coeffs = fit["coeffs"]
    u = jnp.log(x) if fit["log_x"] else x
    u = jnp.clip(2 * (u - fit["x0"]) / (fit["x1"] - fit["x0"]) - 1, -1.0, 1.0)
    v = jnp.clip(2 * (y - fit["y0"]) / (fit["y1"] - fit["y0"]) - 1, -1.0, 1.0)
    dx1, dy1 = coeffs.shape

    def inner(k):
        # g_k(v) = sum_l coeffs[k, l] T_l(v), rolling recurrence
        T_prev, T_cur = jnp.ones_like(v), v
        g = coeffs[k, 0] * T_prev
        if dy1 > 1:
            g = g + coeffs[k, 1] * T_cur
        for _l in range(2, dy1):
            T_prev, T_cur = T_cur, 2 * v * T_cur - T_prev
            g = g + coeffs[k, _l] * T_cur
        return g

    Tx_prev, Tx_cur = jnp.ones_like(u), u
    out = inner(0) * Tx_prev
    if dx1 > 1:
        out = out + inner(1) * Tx_cur
    for _k in range(2, dx1):
        Tx_prev, Tx_cur = Tx_cur, 2 * u * Tx_cur - Tx_prev
        out = out + inner(_k) * Tx_cur
    return out


def make_table_eval(x_side, y_side, table):
    """(x, y) -> values: EXACT bilinear interpolation of a small 2-D
    table with ZERO gathers.

    Uses the clamped-ramp double-difference identity for a bilinear
    surface on an (nx, ny) grid in fractional-index coordinates (u, v):

        P(u, v) = T[0,0] + sum_i a_i r_i(u) + sum_j b_j r_j(v)
                  + sum_ij m_ij r_i(u) r_j(v),   r_k(t) = clip(t-k, 0, 1)

    with a = dT[:,0], b = dT[0,:], m = d(dT) the first/second mixed
    differences — every coefficient a host SCALAR, so evaluation is pure
    elementwise flops (~2 nx ny ops/point) with no gathers, numerically
    identical to the 4-corner-gather bilinear.
    """
    tab = np.asarray(table, dtype=np.float64)
    nx, ny = tab.shape
    tx = _axis_transform(np.asarray(x_side))
    ty = _axis_transform(np.asarray(y_side))
    dx_ = np.diff(tab, axis=0)  # (nx-1, ny)
    a = dx_[:, 0]  # (nx-1,)
    b = np.diff(tab[0, :])  # (ny-1,)
    m = np.diff(dx_, axis=1)  # (nx-1, ny-1)
    c00 = float(tab[0, 0])

    def fn(x, y):
        u = jnp.clip(_fractional_index_transformed(tx, x), 0.0, nx - 1.0)
        v = jnp.clip(_fractional_index_transformed(ty, y), 0.0, ny - 1.0)
        rv = [jnp.clip(v - j, 0.0, 1.0) for j in range(ny - 1)]  # hoisted
        out = c00
        for j in range(ny - 1):
            out = out + np.float32(b[j]) * rv[j]
        for i in range(nx - 1):
            ru = jnp.clip(u - i, 0.0, 1.0)
            g = np.float32(a[i])
            for j in range(ny - 1):
                g = g + np.float32(m[i, j]) * rv[j]
            out = out + ru * g
        return out

    return fn
