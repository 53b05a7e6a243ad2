"""Map binning kernels.

Where scatter-adds are slow, the binning path exploits the scan geometry
the same way the windowed sampler does: within a short time chunk, every
detector sample falls in a small pixel window around the boresight
track. Binning then becomes a pair of one-hot hat matrices contracted
per chunk,

    window[y, x] = sum_{d,t} data[d,t] * 1[iy=oy+y] * 1[ix=ox+x]
                 = einsum('dty,dtx->yx', onehot_y * data, onehot_x)

followed by ONE dynamic-slice accumulate of the (wy, wx) window per
chunk — no scatters anywhere. Window origins are host-precomputed from
the (static) pointing; a host-side check guarantees the windows cover
every sample, falling back to segment_sum otherwise.

Reference behavior: maria/mappers/bin_mapper.py:100-112 (sparse CSR
matvec on the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "blockify_ids",
    "blocked_local_ids",
    "WindowedBinPlan",
    "make_windowed_bin_plan",
    "bin_windowed",
    "bin_scatter",
    "BlockedBinPlan",
    "make_blocked_bin_plan",
    "make_blocked_bin_plan_on_device",
    "bin_blocked",
]


@dataclass
class WindowedBinPlan:
    """Host-precomputed static geometry for `bin_windowed`."""

    n_y: int
    n_x: int
    wy: int
    wx: int
    chunk: int
    n_chunks: int
    origins: np.ndarray  # (n_chunks, 2) int32 window corners (oy, ox)
    iy: np.ndarray  # (n_det, n_chunks * chunk) int32, padded with -1
    ix: np.ndarray


def make_windowed_bin_plan(iy, ix, n_y: int, n_x: int, chunk: int = 64) -> WindowedBinPlan:
    """Build the plan from static per-sample pixel rows/cols.

    Returns None if any chunk's pixel span exceeds a sane window size
    (then use `bin_scatter`). Out-of-map samples must already be marked
    with negative indices (they get zero one-hot weight).
    """
    iy = np.asarray(iy, dtype=np.int32)
    ix = np.asarray(ix, dtype=np.int32)
    n_det, n_t = iy.shape
    n_chunks = -(-n_t // chunk)
    pad = n_chunks * chunk - n_t
    if pad:
        iy = np.pad(iy, ((0, 0), (0, pad)), constant_values=-1)
        ix = np.pad(ix, ((0, 0), (0, pad)), constant_values=-1)

    iy_c = iy.reshape(n_det, n_chunks, chunk)
    ix_c = ix.reshape(n_det, n_chunks, chunk)
    valid = iy_c >= 0

    def span(a):
        lo = np.where(valid, a, np.iinfo(np.int32).max).min(axis=(0, 2))
        hi = np.where(valid, a, -1).max(axis=(0, 2))
        lo = np.minimum(lo, hi)  # empty chunks
        return lo, hi

    oy, hi_y = span(iy_c)
    ox, hi_x = span(ix_c)
    wy = int(-(-(hi_y - oy + 1).max() // 8) * 8)
    wx = int(-(-(hi_x - ox + 1).max() // 8) * 8)
    if wy * wx > 0.5 * n_y * n_x or wy > n_y or wx > n_x:
        return None  # windows wouldn't pay off; caller falls back to scatter

    oy = np.clip(oy, 0, n_y - wy)
    ox = np.clip(ox, 0, n_x - wx)
    return WindowedBinPlan(
        n_y=n_y, n_x=n_x, wy=wy, wx=wx, chunk=chunk, n_chunks=n_chunks,
        origins=np.stack([oy, ox], axis=-1).astype(np.int32),
        iy=iy, ix=ix,
    )


def bin_windowed(data, plan: WindowedBinPlan, weights=None, iy=None, ix=None):
    """Bin data into (n_y, n_x) maps with the MXU.

    `data` is (n_det, n_t) or channel-stacked (n_ch, n_det, n_t) — all
    channels share ONE set of one-hot hat matrices (built once per
    chunk), so multi-Stokes binning costs the matmuls, not the hats.
    `weights` optionally scales each sample (same shape as data).
    `iy`/`ix` optionally override the plan's index arrays with device
    arrays — pass them as jit ARGUMENTS for large detector counts, since
    closure constants of that size blow the remote-compile request.
    Pure jnp; call under jit.
    """
    squeeze = data.ndim == 2
    if squeeze:
        data = data[None]
        if weights is not None:
            weights = weights[None]
    n_ch, n_det, n_t = data.shape
    pad = plan.n_chunks * plan.chunk - n_t
    if weights is not None:
        data = data * weights
    if pad:
        data = jnp.pad(data, ((0, 0), (0, 0), (0, pad)))

    iy = jnp.asarray(plan.iy) if iy is None else iy
    ix = jnp.asarray(plan.ix) if ix is None else ix
    data_c = data.reshape(n_ch, n_det, plan.n_chunks, plan.chunk)
    iy_c = iy.reshape(n_det, plan.n_chunks, plan.chunk)
    ix_c = ix.reshape(n_det, plan.n_chunks, plan.chunk)
    origins = jnp.asarray(plan.origins)

    ky = jnp.arange(plan.wy, dtype=jnp.int32)
    kx = jnp.arange(plan.wx, dtype=jnp.int32)

    def body(m, args):
        d, ly, lx, origin = args  # d: (n_ch, n_det, chunk)
        # one-hot hats; out-of-window (incl. padded/off-map) rows vanish
        wY = (ly[..., None] == ky).astype(d.dtype)  # (n_det, chunk, wy)
        wX = (lx[..., None] == kx).astype(d.dtype)  # (n_det, chunk, wx)
        # full f32: a default-precision matmul may truncate the data
        # (bf16 or TF32), which is visible in binned sums
        window = jnp.einsum(
            "dcy,dcx,mdc->myx", wY, wX, d, precision=jax.lax.Precision.HIGHEST
        )
        block = jax.lax.dynamic_slice(m, (0, origin[0], origin[1]), (n_ch, plan.wy, plan.wx))
        m = jax.lax.dynamic_update_slice(m, block + window, (0, origin[0], origin[1]))
        return m, ()

    m0 = jnp.zeros((n_ch, plan.n_y, plan.n_x), dtype=data.dtype)
    ly = jnp.moveaxis(iy_c, 1, 0) - origins[:, 0][:, None, None]
    lx = jnp.moveaxis(ix_c, 1, 0) - origins[:, 1][:, None, None]
    m, _ = jax.lax.scan(body, m0, (jnp.moveaxis(data_c, 2, 0), ly, lx, origins))
    return m[0] if squeeze else m


@dataclass
class BlockedBinPlan:
    """Host-precomputed geometry for `bin_blocked`.

    Generalizes `WindowedBinPlan` by blocking the DETECTOR axis too:
    for wide-field arrays (AtLAST-scale) the instantaneous footprint of
    all detectors covers most of the map, so per-time-chunk windows
    don't pay — but a Morton-ordered block of neighboring detectors
    over a short time chunk still lands in a small window. Each
    (det-block, time-chunk) pair gets its own window origin; local
    offsets are stored as int8 when the window allows (4x less index
    bandwidth than the flat int32 pixel ids)."""

    n_y: int
    n_x: int
    wy: int
    wx: int
    chunk: int
    n_chunks: int
    det_block: int
    n_blocks: int
    n_t: int
    order: np.ndarray  # (n_blocks * det_block,) int32 padded detector order
    ly: np.ndarray  # (n_blocks, det_block, n_chunks, chunk) local y offsets, -1 = skip
    lx: np.ndarray
    origins: np.ndarray  # (n_blocks, n_chunks, 2) int32 window corners

    def device_args(self):
        """Index arrays as jit ARGUMENTS (closure constants of this size
        blow the remote-compile request limit)."""
        return (
            jnp.asarray(self.ly),
            jnp.asarray(self.lx),
            jnp.asarray(self.origins),
            jnp.asarray(self.order),
        )


def split_bf16(x):
    """(hi, lo) bf16 parts of float32 `x` with hi + lo == x to ~2^-16
    relative. `hi` is x rounded to bf16 by integer ops on its bits (add
    half an ulp, clear the low 16 bits), so the split survives XLA's
    excess-precision simplification, which on a GPU folds an
    f32 -> bf16 -> f32 round trip away and would leave lo == 0.
    x - hi is exact in float32."""
    x = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    hi_bits = (bits + jnp.uint32(0x8000)) & jnp.uint32(0xFFFF0000)
    hi = jax.lax.bitcast_convert_type(hi_bits, jnp.float32)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def _hilbert_order(my, mx, order_bits: int = 16):
    """Sort detectors along a Hilbert curve of their mean pixel position.
    Unlike a Morton/Z-order sort (whose quadrant crossings put spatially
    distant detectors in the same block, inflating the global window),
    every consecutive Hilbert range is spatially compact."""
    y = np.asarray(my, dtype=np.int64).copy()
    x = np.asarray(mx, dtype=np.int64).copy()
    d = np.zeros_like(x)
    s = 1 << (order_bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate the quadrant frame
        swap = ry == 0
        flip = swap & (rx == 1)
        x_s, y_s = x.copy(), y.copy()
        x[swap], y[swap] = y_s[swap], x_s[swap]
        x[flip] = s - 1 - x[flip]
        y[flip] = s - 1 - y[flip]
        s //= 2
    return np.argsort(d, kind="stable")


def hilbert_detector_order(iy, ix):
    """Hilbert-curve ordering of detectors by their mean pixel position.
    Computed once per (TOD, band) and reused across time bins — the
    pointing is shared, so re-sorting per bin is wasted host work."""
    iy = np.asarray(iy, dtype=np.int32)
    ix = np.asarray(ix, dtype=np.int32)
    valid0 = (iy >= 0) & (ix >= 0)
    my = np.where(valid0, iy, 0).sum(axis=1) / np.maximum(valid0.sum(axis=1), 1)
    mx = np.where(valid0, ix, 0).sum(axis=1) / np.maximum(valid0.sum(axis=1), 1)
    return _hilbert_order(np.round(my).astype(np.int64), np.round(mx).astype(np.int64))


def make_blocked_bin_plan(
    iy,
    ix,
    n_y: int,
    n_x: int,
    chunk: int = 64,
    det_block: int = 512,
    max_window_frac: float = 0.5,
    order: np.ndarray = None,
    force_window: tuple = None,
) -> BlockedBinPlan:
    """Build the plan from static per-sample pixel rows/cols (n_det, n_t).

    Out-of-map samples must be marked with negative indices (they get
    zero one-hot weight). Returns None when even blocked windows would
    span most of the map (then use `bin_scatter`). Pass a precomputed
    `order` (hilbert_detector_order) to share the sort across time bins.
    `force_window=(wy, wx)` overrides the fitted window size — the
    sharded binner uses it to give every shard's plan identical static
    shapes (returns None if the forced window cannot cover a block)."""
    iy = np.asarray(iy, dtype=np.int32)
    ix = np.asarray(ix, dtype=np.int32)
    n_det, n_t = iy.shape
    # small arrays: don't pad a 217-detector instrument up to a full
    # 512-row block (dead rows cost real matmul work)
    det_block = min(det_block, -(-n_det // 8) * 8)

    if order is None:
        order = hilbert_detector_order(iy, ix)

    n_blocks = -(-n_det // det_block)
    pad_d = n_blocks * det_block - n_det
    order_p = (
        np.concatenate([order, np.full(pad_d, order[-1], dtype=order.dtype)]) if pad_d else order
    )
    n_chunks = -(-n_t // chunk)
    pad_t = n_chunks * chunk - n_t

    def blockify(a):
        a = a[order_p]
        if pad_t:
            a = np.pad(a, ((0, 0), (0, pad_t)), constant_values=-1)
        if pad_d:
            a[n_det:] = -1  # padded detector rows contribute nothing
        return a.reshape(n_blocks, det_block, n_chunks, chunk)

    iy_b, ix_b = blockify(iy), blockify(ix)
    # a sample off-map in EITHER axis is invalid (the docstring contract
    # allows marking just one); judging by iy alone would drag that
    # pair's x-origin to -1 and inflate the global window
    valid = (iy_b >= 0) & (ix_b >= 0)

    def span(a):
        lo = np.where(valid, a, np.iinfo(np.int32).max).min(axis=(1, 3))
        hi = np.where(valid, a, -1).max(axis=(1, 3))
        return np.minimum(lo, hi), hi

    oy, hi_y = span(iy_b)
    ox, hi_x = span(ix_b)
    wy = int(-(-(hi_y - oy + 1).max() // 8) * 8)
    wx = int(-(-(hi_x - ox + 1).max() // 8) * 8)
    if force_window is not None:
        if force_window[0] < wy or force_window[1] < wx:
            return None  # forced window cannot cover some block
        wy, wx = int(force_window[0]), int(force_window[1])
    if wy * wx > max_window_frac * n_y * n_x or wy > n_y or wx > n_x:
        return None
    oy = np.clip(oy, 0, n_y - wy)
    ox = np.clip(ox, 0, n_x - wx)

    off_dtype = np.int8 if max(wy, wx) < 127 else np.int32
    ly = np.where(valid, iy_b - oy[:, None, :, None], -1).astype(off_dtype)
    lx = np.where(valid, ix_b - ox[:, None, :, None], -1).astype(off_dtype)
    return BlockedBinPlan(
        n_y=n_y, n_x=n_x, wy=wy, wx=wx, chunk=chunk, n_chunks=n_chunks,
        det_block=det_block, n_blocks=n_blocks, n_t=n_t,
        order=order_p.astype(np.int32), ly=ly, lx=lx,
        origins=np.stack([oy, ox], axis=-1).astype(np.int32),
    )


def blockify_ids(a, order_dev, n_det: int, det_block: int, n_blocks: int,
                 n_chunks: int, chunk: int):
    """Traceable blockify of a (n_det, n_t) id array: reorder detectors,
    pad time with -1, mask padded det rows with -1, reshape to
    (n_blocks, det_block, n_chunks, chunk). The single source of the
    -1/padding conventions for the device plan builder AND the
    streaming executor's in-scan binning."""
    a = jnp.take(a, order_dev, axis=0)
    pad_t = n_chunks * chunk - a.shape[1]
    if pad_t:
        a = jnp.pad(a, ((0, 0), (0, pad_t)), constant_values=-1)
    if n_blocks * det_block > n_det:
        row = jnp.arange(n_blocks * det_block, dtype=jnp.int32)[:, None]
        a = jnp.where(row >= n_det, jnp.int32(-1), a)
    return a.reshape(n_blocks, det_block, n_chunks, chunk)


def blocked_local_ids(iy, ix, order_dev, n_det: int, det_block: int,
                      n_blocks: int, n_chunks: int, chunk: int,
                      wy: int, wx: int, n_y: int, n_x: int):
    """Traceable per-(det-block, time-chunk) window origins + local
    offsets for a STATIC (wy, wx) window: origins are each pair's
    clamped minimum valid pixel; `lost` flags valid samples the window
    cannot cover (marked -1 so an int8 cast can never alias them back
    in). Used inside the streaming executor's scan, where the ids are
    traced values and only the window size is static."""
    iy_b = blockify_ids(iy, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)
    ix_b = blockify_ids(ix, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)
    valid = (iy_b >= 0) & (ix_b >= 0)
    big = jnp.int32(1 << 30)
    oy = jnp.clip(jnp.where(valid, iy_b, big).min(axis=(1, 3)), 0, n_y - wy)
    ox = jnp.clip(jnp.where(valid, ix_b, big).min(axis=(1, 3)), 0, n_x - wx)
    ly = jnp.where(valid, iy_b - oy[:, None, :, None], -1)
    lx = jnp.where(valid, ix_b - ox[:, None, :, None], -1)
    lost = ((ly >= wy) | (lx >= wx)) & valid
    ly = jnp.where(lost, -1, ly)
    lx = jnp.where(lost, -1, lx)
    return ly, lx, jnp.stack([oy, ox], axis=-1), lost


def make_blocked_bin_plan_on_device(
    iy,
    ix,
    n_y: int,
    n_x: int,
    chunk: int = 64,
    det_block: int = 512,
    max_window_frac: float = 0.5,
    order: np.ndarray = None,
) -> BlockedBinPlan:
    """Device-side twin of `make_blocked_bin_plan`.

    `iy`/`ix` are DEVICE arrays (n_det, n_t). Every O(n_det * n_t) pass
    (blockify, span reductions, local-offset subtraction) runs as a
    jitted device program; the host only sees per-detector means (for
    the Hilbert sort), the per-(block, chunk) span scalars, and the
    static window decision. At AtLAST scale (5e4 det x 1.2e4 t) the
    host path burns tens of minutes on one core — the device path is
    milliseconds of reductions plus tiny readbacks. The returned plan's
    ly/lx stay on device (device_args passes them through)."""
    import jax

    iy = jnp.asarray(iy, jnp.int32)
    ix = jnp.asarray(ix, jnp.int32)
    n_det, n_t = iy.shape
    det_block = min(det_block, -(-n_det // 8) * 8)
    n_blocks = -(-n_det // det_block)
    pad_d = n_blocks * det_block - n_det
    n_chunks = -(-n_t // chunk)
    pad_t = n_chunks * chunk - n_t

    if order is None:

        @jax.jit
        def _means(iy, ix):
            valid = (iy >= 0) & (ix >= 0)
            cnt = jnp.maximum(valid.sum(axis=1), 1)
            my = jnp.where(valid, iy, 0).sum(axis=1) / cnt
            mx = jnp.where(valid, ix, 0).sum(axis=1) / cnt
            return my, mx

        my, mx = _means(iy, ix)
        order = _hilbert_order(
            np.round(np.asarray(my)).astype(np.int64),
            np.round(np.asarray(mx)).astype(np.int64),
        )
    order_p = (
        np.concatenate([order, np.full(pad_d, order[-1], dtype=order.dtype)]) if pad_d else order
    )
    order_dev = jnp.asarray(order_p.astype(np.int32))

    def _blockify(a, order_dev):
        return blockify_ids(a, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)

    @jax.jit
    def _spans(iy, ix, order_dev):
        iy_b = _blockify(iy, order_dev)
        ix_b = _blockify(ix, order_dev)
        valid = (iy_b >= 0) & (ix_b >= 0)
        big = jnp.int32(1 << 30)

        def span(a):
            lo = jnp.where(valid, a, big).min(axis=(1, 3))
            hi = jnp.where(valid, a, -1).max(axis=(1, 3))
            return jnp.minimum(lo, hi), hi

        (oy, hy) = span(iy_b)
        (ox, hx) = span(ix_b)
        return oy, hy, ox, hx

    oy, hi_y, ox, hi_x = (np.asarray(v) for v in _spans(iy, ix, order_dev))
    wy = int(-(-(hi_y - oy + 1).max() // 8) * 8)
    wx = int(-(-(hi_x - ox + 1).max() // 8) * 8)
    if wy * wx > max_window_frac * n_y * n_x or wy > n_y or wx > n_x:
        return None
    oy = np.clip(oy, 0, n_y - wy)
    ox = np.clip(ox, 0, n_x - wx)

    off_dtype = jnp.int8 if max(wy, wx) < 127 else jnp.int32

    @jax.jit
    def _locals(iy, ix, order_dev, oy_d, ox_d):
        iy_b = _blockify(iy, order_dev)
        ix_b = _blockify(ix, order_dev)
        valid = (iy_b >= 0) & (ix_b >= 0)
        ly = jnp.where(valid, iy_b - oy_d[:, None, :, None], -1).astype(off_dtype)
        lx = jnp.where(valid, ix_b - ox_d[:, None, :, None], -1).astype(off_dtype)
        return ly, lx

    ly, lx = _locals(iy, ix, order_dev, jnp.asarray(oy), jnp.asarray(ox))
    return BlockedBinPlan(
        n_y=n_y, n_x=n_x, wy=wy, wx=wx, chunk=chunk, n_chunks=n_chunks,
        det_block=det_block, n_blocks=n_blocks, n_t=n_t,
        order=order_p.astype(np.int32), ly=ly, lx=lx,
        origins=np.stack([oy, ox], axis=-1).astype(np.int32),
    )


def bin_blocked(
    data,
    plan: BlockedBinPlan,
    weights=None,
    ly=None,
    lx=None,
    origins=None,
    order=None,
    precision=None,
    pvary_axes=None,
):
    """Bin data into (n_y, n_x) maps with per-(det-block, time-chunk)
    MXU one-hot contractions — no scatters of any size.

    `data` is (n_det, n_t) or channel-stacked (n_ch, n_det, n_t); all
    channels share one set of one-hot hats per (block, chunk). Pass the
    plan's `device_args()` as jit arguments for large arrays.
    `precision` sets the contraction precision. Default HIGH (3-pass
    bf16): max error 5.8e-6 vs 5.0e-6 for HIGHEST — both are dominated
    by f32 accumulation order, while DEFAULT (single-pass) may truncate
    the data (bf16 ~2e-3; TF32 on an H100). Pure jnp; call
    under jit."""
    precision = jax.lax.Precision.HIGH if precision is None else precision
    ly = jnp.asarray(plan.ly) if ly is None else ly
    lx = jnp.asarray(plan.lx) if lx is None else lx
    origins = jnp.asarray(plan.origins) if origins is None else origins
    order = jnp.asarray(plan.order) if order is None else order

    squeeze = data.ndim == 2
    if squeeze:
        data = data[None]
        if weights is not None:
            weights = weights[None]
    if weights is not None:
        data = data * weights
    n_ch, n_det, n_t = data.shape
    pad_t = plan.n_chunks * plan.chunk - n_t

    d = jnp.take(data, order, axis=1)
    if pad_t:
        d = jnp.pad(d, ((0, 0), (0, 0), (0, pad_t)))
    d = d.reshape(n_ch, plan.n_blocks, plan.det_block, plan.n_chunks, plan.chunk)

    ky = jnp.arange(plan.wy, dtype=jnp.int32)
    kx = jnp.arange(plan.wx, dtype=jnp.int32)

    def chunk_body(m, c):
        def block_body(b, m):
            # one-hot hats; out-of-window (padded / off-map, offset -1)
            # samples vanish
            if precision == "hilo":
                # 2-pass split: one-hot entries and each half of the
                # data are bf16-exact, so per-sample rounding is only
                # the residual the lo half can't carry — two bf16
                # significands hold ~16 bits, ~2^-16 (~1e-5) relative,
                # vs bf16's own 2^-8. Measured tighter than HIGH vs an
                # f64 scatter at equal speed (tests/test_binning.py),
                # and cheaper (bf16 hats halve the hat traffic; 2 MXU
                # passes instead of 3)
                wY = (ly[b, :, c][..., None] == ky).astype(jnp.bfloat16)
                wX = (lx[b, :, c][..., None] == kx).astype(jnp.bfloat16)
                dt = d[:, b, :, c]
                d_hi, d_lo = split_bf16(dt)
                win = sum(
                    jnp.einsum(
                        "dcy,dcx,mdc->myx", wY, wX, part,
                        preferred_element_type=jnp.float32,
                    )
                    for part in (d_hi, d_lo)
                )
            elif precision == "shifted":
                # ONE bf16 pass: subtract each channel's per-(block,
                # chunk) valid-sample mean so bf16 rounds the RESIDUAL
                # (~2^-9 of the in-chunk fluctuation, far below any
                # instrument noise), bin [residuals; ones] with shared
                # bf16 hats, and restore the mean exactly through the
                # valid-hit-count window: sum(d h) = sum((d-mu) h) +
                # mu sum(h). A ones channel has zero residual and gets
                # exact counts. 1 MXU pass + half the hat traffic of
                # HIGH's 3 f32-hat passes.
                wY = (ly[b, :, c][..., None] == ky).astype(jnp.bfloat16)
                wX = (lx[b, :, c][..., None] == kx).astype(jnp.bfloat16)
                dt = d[:, b, :, c]  # (n_ch, det_block, chunk)
                vmask = (ly[b, :, c] >= 0).astype(dt.dtype)
                cnt = jnp.maximum(vmask.sum(), 1.0)
                mu = (dt * vmask).sum(axis=(1, 2)) / cnt  # (n_ch,)
                parts = jnp.concatenate(
                    [dt - mu[:, None, None], jnp.ones_like(dt[:1])], axis=0
                ).astype(jnp.bfloat16)
                win = jnp.einsum(
                    "dcy,dcx,mdc->myx", wY, wX, parts,
                    preferred_element_type=jnp.float32,
                )
                win = win[:-1] + mu[:, None, None] * win[-1]
            else:
                wY = (ly[b, :, c][..., None] == ky).astype(jnp.float32)
                wX = (lx[b, :, c][..., None] == kx).astype(jnp.float32)
                win = jnp.einsum(
                    "dcy,dcx,mdc->myx", wY, wX, d[:, b, :, c], precision=precision
                )
            o = origins[b, c]
            blk = jax.lax.dynamic_slice(m, (0, o[0], o[1]), (n_ch, plan.wy, plan.wx))
            return jax.lax.dynamic_update_slice(m, blk + win, (0, o[0], o[1]))

        return jax.lax.fori_loop(0, plan.n_blocks, block_body, m), ()

    m0 = jnp.zeros((n_ch, plan.n_y, plan.n_x), dtype=jnp.float32)
    if pvary_axes:
        # under shard_map the accumulated windows are device-varying;
        # the scan carry must start with the same varying type
        m0 = jax.lax.pcast(m0, tuple(pvary_axes), to="varying")
    m, _ = jax.lax.scan(chunk_body, m0, jnp.arange(plan.n_chunks))
    return m[0] if squeeze else m


def bin_scatter(data, pix, n_pix: int, weights=None):
    """segment_sum fallback for irregular pointing."""
    if weights is not None:
        data = data * weights
    return jax.ops.segment_sum(data.ravel(), pix.ravel(), num_segments=n_pix)


@dataclass
class RunLengthBinPlan:
    """Host-precomputed run-length compression of static pixel ids.

    A scanning detector dwells several consecutive samples in each map
    pixel, so the (huge) per-sample scatter reduces exactly to a
    (much smaller) per-run scatter: run sums come from differences of a
    per-detector cumulative sum. Two boundary gathers per run pay for
    the smaller scatter, so it wins only where gathers are much cheaper
    per element than scatters.
    """

    n_pix: int
    n_t: int
    starts: np.ndarray  # (n_runs,) int32, flat into the (n_det, n_t+1) cumsum
    ends: np.ndarray  # (n_runs,) int32, exclusive
    run_pix: np.ndarray  # (n_runs,) int32


def make_runlength_bin_plan(pix, n_pix: int) -> RunLengthBinPlan:
    """Build the plan from static per-sample pixel ids (n_det, n_t)."""
    pix = np.asarray(pix, dtype=np.int32)
    n_det, n_t = pix.shape
    # run boundaries: start of row, or pixel change within a row
    change = np.ones((n_det, n_t), dtype=bool)
    change[:, 1:] = pix[:, 1:] != pix[:, :-1]
    det_idx, t_start = np.nonzero(change)
    # local end = next run's start within the same row, else n_t
    t_end = np.empty_like(t_start)
    same_row = det_idx[1:] == det_idx[:-1]
    t_end[:-1] = np.where(same_row, t_start[1:], n_t)
    t_end[-1] = n_t
    # flat indices into the zero-prefixed (n_det, n_t+1) cumsum:
    # run sum over [t0, t1) = cs[det, t1] - cs[det, t0]
    row = det_idx * (n_t + 1)
    return RunLengthBinPlan(
        n_pix=n_pix, n_t=n_t,
        starts=(row + t_start).astype(np.int32),
        ends=(row + t_end).astype(np.int32),
        run_pix=pix[det_idx, t_start].astype(np.int32),
    )


def bin_runlength(data, starts, ends, run_pix, n_pix: int):
    """Exact binning via per-row cumsum + per-run differences.

    `starts`/`ends`/`run_pix` are the plan arrays; pass them as jit
    ARGUMENTS (tens of MB — closure constants blow the compile request)."""
    n_det, n_t = data.shape
    cs = jnp.cumsum(data, axis=-1)
    cs = jnp.concatenate([jnp.zeros((n_det, 1), dtype=data.dtype), cs], axis=-1).ravel()
    run_sums = jnp.take(cs, ends) - jnp.take(cs, starts)
    return jax.ops.segment_sum(run_sums, run_pix, num_segments=n_pix)
