"""Run-compressed one-hot map binning.

A scanning detector dwells several consecutive samples in each map
pixel (measured on the AtLAST-50k daisy bench scene: <=35 pixel runs
per 128-sample chunk, <=63 per 256), so the blocked one-hot binning of
`ops.binning.bin_blocked` wastes contraction depth: every *sample* is a
row of the hat matrices even though runs of them land in the same
pixel. A one-hot contraction pass over a small window costs about the
same per row whatever the window size (the smaller output tile leaves
the matrix units as under-used as it saves FLOPs), so rows are the
currency.

This module compresses rows 3-4x by binning *runs* instead of samples:

  1. Plan time (static pointing): per (det-block, time-chunk) tile,
     detect pixel-run boundaries and record, for a static number of
     run slots R, each run's END index inside its extraction SEGMENT
     (int8), its window-local pixel offsets (int8, -1 = off-map/empty),
     and — because hit counts don't depend on the data — the
     fully-binned per-(block, chunk) COUNT windows and the global hits
     map.
  2. Run time: runsum_r = cs[end_r] - cs[end_{r-1}] where cs is the
     in-segment cumulative sum of the (mean-shifted) data — run starts
     never need extracting since start_r - 1 = end_{r-1}. The cumsum
     values at the static end indices are pulled out with a one-hot
     multiply-reduce (fuses; no gathers, whose per-element cost would
     erase the win). The windowed one-hot contraction then
     runs over det_block * S * R rows instead of det_block * chunk.

The extraction multiply-reduce costs O(samples * R) VPU work, so the
plan splits each chunk into S = chunk/seg extraction SEGMENTS: runs
never cross a segment boundary (slightly more contraction rows) but R
shrinks to the per-segment run count (at seg=chunk=256 the extraction
can cost as much as the compression saves). The scan/window granularity
stays `chunk` (fewer scan iterations win).

Precision: the data is shifted by its per-(block, chunk) mean before
the cumsum, so the bf16 MXU pass rounds only the in-chunk RESIDUAL
run sums (~2^-9 of the fluctuation), and the shift is restored exactly
through the static count windows: sum(h*runsum) = sum(h*(runsum -
mu*cnt)) + mu*sum(h*cnt). This is the `precision="shifted"` scheme of
`bin_blocked` with the count contraction moved to plan time — one MXU
pass per channel per realization. The cumsum-difference itself adds
~ulp(chunk-sum)/runsum ~ 5e-6 relative, the same class as the f32
accumulation-order noise of every other path (tested vs an f64
scatter in tests/test_binning_runs.py).

Contract: `data` must be FINITE everywhere (off-map samples are
excluded through the hats, but a NaN would poison the cumsum for the
rest of its chunk). The fused synthesis program satisfies this.

Reference behavior: maria/mappers/bin_mapper.py:100-112 (sparse CSR
matvec on the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .binning import _hilbert_order, blockify_ids, split_bf16

__all__ = [
    "RunChunkBinPlan",
    "make_runchunk_bin_plan_on_device",
    "bin_runchunk",
    "project_runchunk",
    "bin_runs_traced",
]

# Window area (cells) below which a one-hot contraction pass costs per
# ROW, independent of the window: there larger chunks win (fewer scan
# steps at the same total rows); above it the pass pays per cell and
# smaller chunks win (a smaller per-chunk pixel window). Not tuned for
# the H100: the value was derived on the previous accelerator, and
# which chunk size wins on the card is not measured.
_ROW_BOUND_AREA = 16384


@dataclass
class RunChunkBinPlan:
    """Device-built static geometry for `bin_runchunk`."""

    n_y: int
    n_x: int
    wy: int
    wx: int
    chunk: int
    n_chunks: int
    det_block: int
    n_blocks: int
    n_det: int
    n_t: int
    seg: int  # extraction segment length (divides chunk)
    r_max: int  # run slots per (det, segment), padded to a multiple of 8
    order: np.ndarray  # (n_blocks * det_block,) int32 padded detector order
    e_idx: jnp.ndarray  # (nb, db, nc, S, R) int8/int32 run END index in-segment
    run_ly: jnp.ndarray  # (nb, db, nc, S, R) int8/int32 local y, -1 = skip
    run_lx: jnp.ndarray
    origins: np.ndarray  # (nb, nc, 2) int32 window corners
    wcnt: jnp.ndarray  # (nb, nc, wy, wx) f32 static valid-hit-count windows
    hits: np.ndarray  # (n_y, n_x) f32 static unweighted hit map

    def device_args(self):
        """Index arrays as jit ARGUMENTS (closure constants of this size
        blow the remote-compile request limit)."""
        return (
            jnp.asarray(self.e_idx),
            jnp.asarray(self.run_ly),
            jnp.asarray(self.run_lx),
            jnp.asarray(self.origins),
            jnp.asarray(self.order),
            jnp.asarray(self.wcnt),
        )


def make_runchunk_bin_plan_on_device(
    iy,
    ix,
    n_y: int,
    n_x: int,
    chunk="auto",
    det_block: int = 1024,
    seg: int = 64,
    max_window_frac: float = 0.5,
    max_r_frac: float = 0.75,
    order: np.ndarray = None,
    order_groups=None,
    force_window: tuple = None,
    force_r_max: int = None,
    with_hits: bool = True,
) -> RunChunkBinPlan:
    """Build the run plan from DEVICE pixel ids (n_det, n_t), -1 = off-map.

    Geometry (Hilbert order, windows, origins) matches
    `make_blocked_bin_plan_on_device`; on top of it, every (det, seg)
    row is compressed to its pixel runs (`seg` divides `chunk`; see the
    module docstring for why the two granularities differ). Returns
    None when the windows would span most of the map or when the scan
    moves so fast that runs exceed `max_r_frac * seg` slots (no
    compression to be had) — callers fall back to
    `bin_blocked`/`bin_scatter`.

    `chunk="auto"` (default) picks the scan/window granularity from the
    row/cell cost model: the largest candidate whose windows stay
    row-bound (wy*wx <= `_ROW_BOUND_AREA`, where pass time is rows-only
    and fewer scan steps win), else the candidate minimizing total
    row-equivalents n_chunks * S * r_max * max(_ROW_BOUND_AREA, wy*wx)
    — big maps under slow scans want SMALLER chunks because the
    per-chunk pixel window shrinks with chunk duration.

    All O(n_det * n_t) passes run on device; the host sees per-detector
    means (Hilbert sort), span/run-count scalars, and the static count
    windows. The run-slot extraction scans over (chunk x block) pairs so
    its one-hot intermediates stay small.
    """
    iy = jnp.asarray(iy, jnp.int32)
    ix = jnp.asarray(ix, jnp.int32)
    n_det, n_t = iy.shape
    det_block = min(det_block, -(-n_det // 8) * 8)
    n_blocks = -(-n_det // det_block)
    pad_d = n_blocks * det_block - n_det

    if order is None:

        @jax.jit
        def _means(iy, ix):
            valid = (iy >= 0) & (ix >= 0)
            cnt = jnp.maximum(valid.sum(axis=1), 1)
            my = jnp.where(valid, iy, 0).sum(axis=1) / cnt
            mx = jnp.where(valid, ix, 0).sum(axis=1) / cnt
            return my, mx

        my, mx = _means(iy, ix)
        my = np.round(np.asarray(my)).astype(np.int64)
        mx = np.round(np.asarray(mx)).astype(np.int64)
        if order_groups:
            # GROUP-STABLE ordering: Hilbert-sort within each contiguous
            # detector group (e.g. band blocks), never across. Rows of a
            # group stay inside [start, stop), so a program whose
            # detector axis is permuted to this order keeps its bands
            # contiguous (TODProgram.permute_detectors) and can emit
            # det-blocked TOD the binning consumes with zero relayout
            # (`bin_runchunk(..., data_in_plan_order=True)`). Within-band
            # spatial compactness is nearly as good as global (each band
            # spans the full focal plane).
            order = np.concatenate([
                start + _hilbert_order(my[start:stop], mx[start:stop])
                for start, stop in order_groups
            ])
        else:
            order = _hilbert_order(my, mx)
    order_p = (
        np.concatenate([order, np.full(pad_d, order[-1], dtype=order.dtype)]) if pad_d else order
    )
    order_dev = jnp.asarray(order_p.astype(np.int32))

    def _stats(chunk_c):
        """Span/run stats for one chunk candidate — ONE O(n_det * n_t)
        device pass; the host sees only (nb, nc) spans + a run-count
        scalar."""
        n_chunks_c = -(-n_t // chunk_c)
        seg_c = min(seg, chunk_c)
        n_seg_c = chunk_c // seg_c

        @jax.jit
        def _spans_runs(iy, ix):
            # hold ONLY the two blockified id copies full-size; every
            # other quantity is chunk-local inside the scan. Computing
            # valid/pix/change at full (nb, db, nc, chunk) size (as this
            # pass originally did) peaks at ~7 live full-size buffers —
            # a genuine OOM at AtLAST-50k x 240 s (2.47 GB each on a
            # 15.75 GB chip, hit by tools/profile_atlast_stages.py).
            iy_b = blockify_ids(iy, order_dev, n_det, det_block, n_blocks,
                                n_chunks_c, chunk_c)
            ix_b = blockify_ids(ix, order_dev, n_det, det_block, n_blocks,
                                n_chunks_c, chunk_c)
            big = jnp.int32(1 << 30)

            def body(_, c):
                yb = jax.lax.dynamic_slice_in_dim(iy_b, c, 1, axis=2)[:, :, 0]
                xb = jax.lax.dynamic_slice_in_dim(ix_b, c, 1, axis=2)[:, :, 0]
                valid = (yb >= 0) & (xb >= 0)  # (nb, db, chunk)
                oy_c = jnp.minimum(jnp.where(valid, yb, big).min(axis=(1, 2)),
                                   jnp.where(valid, yb, -1).max(axis=(1, 2)))
                hy_c = jnp.where(valid, yb, -1).max(axis=(1, 2))
                ox_c = jnp.minimum(jnp.where(valid, xb, big).min(axis=(1, 2)),
                                   jnp.where(valid, xb, -1).max(axis=(1, 2)))
                hx_c = jnp.where(valid, xb, -1).max(axis=(1, 2))
                # runs: a new run starts at every segment boundary or
                # wherever the (packed) pixel changes; off-map samples
                # carry pix=-1 and coalesce into runs of their own (their
                # slot gets ly=-1 and vanishes in the hats)
                pix = jnp.where(valid, yb * jnp.int32(n_x) + xb, -1)
                pix_s = pix.reshape(pix.shape[:-1] + (n_seg_c, seg_c))
                change = jnp.concatenate(
                    [jnp.ones(pix_s.shape[:-1] + (1,), bool),
                     pix_s[..., 1:] != pix_s[..., :-1]],
                    axis=-1,
                )
                return 0, (oy_c, hy_c, ox_c, hx_c, change.sum(axis=-1).max())

            _, (oy, hy, ox, hx, nr) = jax.lax.scan(
                body, 0, jnp.arange(n_chunks_c, dtype=jnp.int32)
            )
            # scan stacks chunk-major: (nc, nb) -> (nb, nc)
            return oy.T, hy.T, ox.T, hx.T, nr.max()

        oy, hi_y, ox, hi_x, n_runs = (np.asarray(v) for v in _spans_runs(iy, ix))
        wy = int(-(-(hi_y - oy + 1).max() // 8) * 8)
        wx = int(-(-(hi_x - ox + 1).max() // 8) * 8)
        r_max = int(-(-int(n_runs) // 8) * 8)
        ok = (
            wy * wx <= max_window_frac * n_y * n_x
            and wy <= n_y
            and wx <= n_x
            and r_max <= max_r_frac * seg_c
        )
        return dict(chunk=chunk_c, n_chunks=n_chunks_c, seg=seg_c, n_seg=n_seg_c,
                    oy=oy, ox=ox, wy=wy, wx=wx, r_max=r_max, ok=ok)

    if chunk == "auto":
        candidates = (256, 128, 64)
    else:
        chunk = int(chunk)
        if chunk % min(seg, chunk):
            raise ValueError(f"seg ({seg}) must divide chunk ({chunk})")
        candidates = (chunk,)
    chosen = None
    for c in candidates:  # descending: ties and row-bound prefer LARGER chunks
        st = _stats(c)
        if not st["ok"]:
            continue
        if st["wy"] * st["wx"] <= _ROW_BOUND_AREA:
            # row-bound at the largest qualifying chunk: smaller chunks
            # keep the same total rows but pay more scan steps — stop
            chosen = st
            break
        st["cost"] = (st["n_chunks"] * st["n_seg"] * st["r_max"]
                      * max(_ROW_BOUND_AREA, st["wy"] * st["wx"]))
        if chosen is None or st["cost"] < chosen["cost"]:
            chosen = st
    if chosen is None:
        return None
    chunk, n_chunks, seg, n_seg = (chosen[k] for k in ("chunk", "n_chunks", "seg", "n_seg"))
    wy, wx, r_max = chosen["wy"], chosen["wx"], chosen["r_max"]
    if force_window is not None:
        # uniform static shapes across sibling plans (the streaming
        # executor's resident per-block plans share one compiled scan)
        if force_window[0] < wy or force_window[1] < wx:
            return None
        wy, wx = int(force_window[0]), int(force_window[1])
    if force_r_max is not None:
        if force_r_max < r_max:
            return None
        r_max = int(force_r_max)
    oy = np.clip(chosen["oy"], 0, n_y - wy)
    ox = np.clip(chosen["ox"], 0, n_x - wx)
    oy_d, ox_d = jnp.asarray(oy), jnp.asarray(ox)

    def _blockify(a):
        return blockify_ids(a, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)

    idx_dtype = jnp.int8 if seg <= 128 and max(wy, wx) < 127 else jnp.int32

    @jax.jit
    def _runs(iy, ix, oy_d, ox_d):
        """Per (chunk, block) scan extracting run slots; only the two
        blockified id arrays live full-size (every derived quantity —
        valid/ly/lx/pix — is computed inside the body on its
        (det_block, chunk) tile; materializing them up front peaked at
        ~7 full-size buffers, too many for AtLAST-50k x 240 s)."""
        iy_b = _blockify(iy)
        ix_b = _blockify(ix)

        t_iota = jnp.arange(seg, dtype=jnp.int32)
        r_iota = jnp.arange(r_max, dtype=jnp.int32)

        def body(_, cb):
            c, b = cb // n_blocks, cb % n_blocks
            yb = jax.lax.dynamic_slice(iy_b, (b, 0, c, 0), (1, det_block, 1, chunk))
            xb = jax.lax.dynamic_slice(ix_b, (b, 0, c, 0), (1, det_block, 1, chunk))
            yb = yb[0, :, 0]  # (det_block, chunk)
            xb = xb[0, :, 0]
            valid = (yb >= 0) & (xb >= 0)
            oy_cb = jax.lax.dynamic_slice(oy_d, (b, c), (1, 1))[0, 0]
            ox_cb = jax.lax.dynamic_slice(ox_d, (b, c), (1, 1))[0, 0]
            l_y = jnp.where(valid, yb - oy_cb, -1)
            l_x = jnp.where(valid, xb - ox_cb, -1)
            # pack (ly, lx) so one change test covers both; -1 stays -1
            p = jnp.where(valid, l_y * jnp.int32(wx) + l_x, -1)
            p = p.reshape(det_block, n_seg, seg)
            l_y = l_y.reshape(det_block, n_seg, seg)
            l_x = l_x.reshape(det_block, n_seg, seg)
            change = jnp.concatenate(
                [jnp.ones((det_block, n_seg, 1), bool), p[..., 1:] != p[..., :-1]], axis=-1
            )
            slot = jnp.cumsum(change.astype(jnp.int32), axis=-1) - 1  # (db, S, seg)
            is_end = jnp.concatenate(
                [change[..., 1:], jnp.ones((det_block, n_seg, 1), bool)], axis=-1
            )
            onehot = (slot[..., None] == r_iota).astype(jnp.float32)  # (db, S, seg, R)
            feats = jnp.stack(
                [
                    jnp.where(is_end, t_iota, 0).astype(jnp.float32),
                    jnp.where(change, l_y, 0).astype(jnp.float32),
                    jnp.where(change, l_x, 0).astype(jnp.float32),
                    jnp.ones((det_block, n_seg, seg), jnp.float32),
                ],
                axis=0,
            )  # (4, db, S, seg): end index, start ly, start lx, run length
            out = jnp.einsum("dscr,mdsc->mdsr", onehot, feats)
            e = out[0].astype(jnp.int32)
            r_ly = out[1].astype(jnp.int32)
            r_lx = out[2].astype(jnp.int32)
            cnt = out[3]
            empty = cnt <= 0
            # empty tail slots: end pinned to seg-1 keeps the cumsum
            # extraction monotone (their runsum diffs to zero), hats skip
            e = jnp.where(empty, seg - 1, e)
            r_ly = jnp.where(empty, -1, r_ly)
            r_lx = jnp.where(empty, -1, r_lx)
            # static count window: only valid runs (ly >= 0) count
            hy = (r_ly[..., None] == jnp.arange(wy)).astype(jnp.float32)
            hx = (r_lx[..., None] == jnp.arange(wx)).astype(jnp.float32)
            w = jnp.einsum("dsry,dsrx,dsr->yx", hy, hx, cnt)
            return 0, (e.astype(idx_dtype), r_ly.astype(idx_dtype),
                       r_lx.astype(idx_dtype), w)

        _, (e, r_ly, r_lx, w) = jax.lax.scan(
            body, 0, jnp.arange(n_chunks * n_blocks, dtype=jnp.int32)
        )
        # (nc*nb, db, S, R) -> (nb, db, nc, S, R); (nc*nb, wy, wx) -> (nb, nc, wy, wx)
        def _unflat(a):
            return jnp.moveaxis(
                a.reshape(n_chunks, n_blocks, det_block, n_seg, r_max), 0, 2
            )

        e, r_ly, r_lx = _unflat(e), _unflat(r_ly), _unflat(r_lx)
        w = jnp.moveaxis(w.reshape(n_chunks, n_blocks, wy, wx), 0, 1)
        return e, r_ly, r_lx, w

    e_idx, run_ly, run_lx, wcnt = _runs(iy, ix, oy_d, ox_d)

    # static hits map: count windows placed at their origins
    hits = np.zeros((n_y, n_x), np.float64)
    if with_hits:
        wcnt_h = np.asarray(wcnt, np.float64)
        for b in range(n_blocks):
            for c in range(n_chunks):
                hits[oy[b, c]:oy[b, c] + wy, ox[b, c]:ox[b, c] + wx] += wcnt_h[b, c]

    return RunChunkBinPlan(
        n_y=n_y, n_x=n_x, wy=wy, wx=wx, chunk=chunk, n_chunks=n_chunks,
        det_block=det_block, n_blocks=n_blocks, n_det=n_det, n_t=n_t, seg=seg, r_max=r_max,
        order=order_p.astype(np.int32), e_idx=e_idx, run_ly=run_ly,
        run_lx=run_lx, origins=np.stack([oy, ox], axis=-1).astype(np.int32),
        wcnt=wcnt, hits=hits.astype(np.float32),
    )


def bin_runchunk(
    data,
    plan: RunChunkBinPlan,
    weights=None,
    e_idx=None,
    run_ly=None,
    run_lx=None,
    origins=None,
    order=None,
    wcnt=None,
    precision: str = "shifted",
    pvary_axes=None,
    data_in_plan_order: bool = False,
):
    """Bin (n_det, n_t) or channel-stacked (n_ch, n_det, n_t) data into
    (n_y, n_x) maps through the run-compressed one-hot contraction.

    `data_in_plan_order=True` declares that the detector axis already
    follows `plan.order` (e.g. the fused program was built with
    `TODProgram.permute_detectors(plan.order)`), skipping the row-gather
    relayout — at AtLAST-50k scale the gather can cost more than the
    contraction it feeds. The padded
    tail rows (plan.order repeats the last detector) are still excluded
    through the plan's -1 run slots, but the DATA for them must exist:
    with padding the caller keeps the gather (pad_d rows).

    `precision="shifted"` (default) matches `bin_blocked("shifted")`:
    per-(block, chunk) mean-shifted ONE-pass bf16 MXU contraction with
    the shift restored exactly through the plan's static count windows
    — rounding ~2^-9 of the in-chunk fluctuation, which is tiny for the
    smooth pipeline fields but grows with strongly-varying per-sample
    weights. NOTE: the restore turns pixels whose channel data is
    uniformly ZERO (e.g. time-bin-masked frames) into ~1e-7-scale
    cancellation residue instead of exact zeros. `precision="hilo"`
    splits the UNSHIFTED run sums into two bf16-exact halves (two MXU
    passes, ~2^-16 of the run-sum scale) — use it for high-variance
    channels and whenever exact zeros matter (a naive-map division or a
    Jacobi preconditioner would otherwise amplify the residue —
    measured to break the ML mapper's CG). `data` must be finite
    everywhere (see
    module docstring). Pass `plan.device_args()` through the keyword
    arguments under jit (closure constants of that size blow the remote
    compile request). Pure jnp; call under jit.
    """
    e_idx = jnp.asarray(plan.e_idx) if e_idx is None else e_idx
    run_ly = jnp.asarray(plan.run_ly) if run_ly is None else run_ly
    run_lx = jnp.asarray(plan.run_lx) if run_lx is None else run_lx
    origins = jnp.asarray(plan.origins) if origins is None else origins
    order = jnp.asarray(plan.order) if order is None else order
    wcnt = jnp.asarray(plan.wcnt) if wcnt is None else wcnt

    squeeze = data.ndim == 2
    if squeeze:
        data = data[None]
        if weights is not None:
            weights = weights[None]
    if weights is not None:
        data = data * weights
    n_ch, n_det, n_t = data.shape
    nb, db, nc, C, R = plan.n_blocks, plan.det_block, plan.n_chunks, plan.chunk, plan.r_max
    seg = plan.seg
    n_seg = C // seg
    pad_t = nc * C - n_t

    if data_in_plan_order:
        # rows already follow plan.order; only the block-grid row pad
        # remains (those rows are excluded via the plan's -1 slots, but
        # must exist and be finite). Row and time pads ride ONE jnp.pad
        # (each pad op is a separate full-size pass).
        d = data
        pad_d = nb * db - d.shape[1]
        if pad_d or pad_t:
            # edge padding (NOT zeros): padded samples are already
            # excluded through the plan's -1 ids, but they enter the
            # per-(block, chunk) mean — zeros would drag the shift off
            # its data and blow the bf16 residual rounding up to the
            # full signal scale
            d = jnp.pad(d, ((0, 0), (0, pad_d), (0, pad_t)), mode="edge")
    else:
        d = jnp.take(data, order, axis=1)
        if pad_t:
            d = jnp.pad(d, ((0, 0), (0, 0), (0, pad_t)), mode="edge")
    # KEEP the (n_ch, rows, time) layout: slicing the time axis of the
    # contiguous array inside the scan is a clean per-chunk DMA, while
    # a 5-D (nb, db, nc, C) view forces XLA to materialize a tiled
    # relayout of the whole array up front (the same cost class as a
    # moveaxis)

    ky = jnp.arange(plan.wy, dtype=jnp.int32)
    kx = jnp.arange(plan.wx, dtype=jnp.int32)
    t_iota = jnp.arange(seg, dtype=jnp.int32)

    def chunk_body(m, args):
        c, e_c, ly_c, lx_c, org_c = args
        # the chunk's data AND count windows are sliced IN-BODY instead
        # of riding the scan xs: moving their chunk axis to the front
        # for xs is a full-size strided relayout XLA materializes up
        # front; the time-axis dynamic_slice reads the synthesis layout
        # directly
        d_c = jax.lax.dynamic_slice_in_dim(d, c * C, C, axis=2)
        d_c = d_c.reshape(n_ch, nb, db, C)
        wcnt_c = jax.lax.dynamic_slice_in_dim(wcnt, c, 1, axis=1)[:, 0]
        # d_c (n_ch, nb, db, C); e_c/ly_c/lx_c (nb, db, S, R); org_c (nb, 2)
        if precision == "hilo":
            # unshifted: zero data stays EXACTLY zero (no restore term)
            mu = jnp.zeros((n_ch, nb), d_c.dtype)
        else:
            mu = d_c.mean(axis=(2, 3))  # (n_ch, nb) — any shift is exact
        cs = jnp.cumsum(
            (d_c - mu[:, :, None, None]).reshape(n_ch, nb, db, n_seg, seg), axis=-1
        )
        # cumsum at each run's static in-segment end index: one-hot
        # multiply-reduce (fuses into the reduction — no gather, no
        # materialized one-hot); cost ~ samples * R, which is why runs
        # are extracted per SEGMENT, not per chunk
        end_hat = (e_c.astype(jnp.int32)[..., None, :] == t_iota[:, None]).astype(cs.dtype)
        cse = (cs[..., None] * end_hat[None]).sum(axis=4)  # (n_ch, nb, db, S, R)
        runsum = cse - jnp.concatenate(
            [jnp.zeros(cse.shape[:-1] + (1,), cse.dtype), cse[..., :-1]], axis=-1
        )
        wY = (ly_c.astype(jnp.int32)[..., None] == ky).astype(jnp.bfloat16)
        wX = (lx_c.astype(jnp.int32)[..., None] == kx).astype(jnp.bfloat16)
        if precision == "hilo":
            hi, lo = split_bf16(runsum)
            parts = jnp.concatenate([hi, lo], axis=0)  # hats shared
            win2 = jnp.einsum(
                "bdsry,bdsrx,mbdsr->mbyx", wY, wX, parts,
                preferred_element_type=jnp.float32,
            )
            win = win2[:n_ch] + win2[n_ch:]
        else:
            win = jnp.einsum(
                "bdsry,bdsrx,mbdsr->mbyx", wY, wX, runsum.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        win = win + mu[:, :, None, None] * wcnt_c[None]

        # vectorized placement: pad each block's window to the full map
        # and ROLL it to its origin (origins are clipped to the map, so
        # the roll never wraps), then reduce over blocks. The previous
        # per-block dynamic-update-slice fori_loop was a SEQUENTIAL
        # nb x nc chain of tiny map updates; this is one fused pass over
        # (nb, n_y, n_x) per chunk.
        full = jnp.pad(
            win, ((0, 0), (0, 0), (0, plan.n_y - plan.wy), (0, plan.n_x - plan.wx)))
        placed = jax.vmap(
            lambda w, o: jnp.roll(w, shift=(o[0], o[1]), axis=(-2, -1)),
            in_axes=(1, 0), out_axes=1,
        )(full, org_c)
        return m + placed.sum(axis=1), ()

    m0 = jnp.zeros((n_ch, plan.n_y, plan.n_x), dtype=jnp.float32)
    if pvary_axes:
        m0 = jax.lax.pcast(m0, tuple(pvary_axes), to="varying")
    xs = (
        jnp.arange(nc, dtype=jnp.int32),
        jnp.moveaxis(e_idx, 2, 0),
        jnp.moveaxis(run_ly, 2, 0),
        jnp.moveaxis(run_lx, 2, 0),
        jnp.moveaxis(origins, 1, 0),
    )
    m, _ = jax.lax.scan(chunk_body, m0, xs)
    return m[0] if squeeze else m


def bin_runs_traced(
    data,
    iy,
    ix,
    order_dev,
    *,
    n_det: int,
    det_block: int,
    n_blocks: int,
    n_chunks: int,
    chunk: int,
    seg: int,
    r_max: int,
    wy: int,
    wx: int,
    n_y: int,
    n_x: int,
    precision: str = "shifted",
):
    """Run-compressed MXU binning from TRACED pixel ids — the streaming
    executor's in-scan binner (VERDICT r4 item 2 / builder attack #6).

    The batch `bin_runchunk` consumes a host/device-prebuilt static run
    plan; a streamed observation computes its pixel ids in-program per
    time block, so the full-TOD id arrays never materialize and no plan
    can be prebuilt. This routine fuses the plan-build (run detection +
    slot assignment) and the contraction into one traced pass over ONE
    block's ids. Since a stream IS one realization, the fused plan-build
    costs exactly the work the batch path spends once at plan time.

    Layout discipline (the difference between ~10 and ~45 ms per
    AtLAST-50k block, tools/probe_stream_binning.py): ids and data stay
    in their (rows, time) synthesis layout — per-chunk dynamic slices
    are clean DMAs, while a (nb, db, nc, chunk) blockify forces XLA to
    materialize tiled relayout copies of every array. Everything else
    (origins, run extraction, hats) happens on the chunk tile in-body.
    Padded detector rows ride a single appended SENTINEL row (ids -1,
    data 0) instead of a full-size where-pass. Precision is the
    `shifted` scheme: the per-(det-block) chunk mean is subtracted
    before the bf16 contraction and restored exactly through the
    in-scan count windows — which double as the hit-count map, so sums
    and weights share one 2-channel MXU pass.

    `data` must be FINITE everywhere (module contract); `iy`/`ix` are
    this block's traced pixel ids, -1 = off-map. `lost` counts valid
    samples dropped by the static window or run-slot bound — callers
    must raise on a nonzero total rather than bias the map
    (StreamingExecutor does).

    Returns (map_sum (n_y, n_x) f32, map_wgt (n_y, n_x) f32, lost ()).
    Pure jnp; call under jit.

    Reference behavior: maria/mappers/bin_mapper.py:100-112.
    """
    nb, db = n_blocks, det_block
    n_seg = chunk // seg
    rows = nb * db
    n_t = iy.shape[1]
    pad_t = n_chunks * chunk - n_t

    # sentinel row: padded detector slots point at one appended row of
    # off-map ids / zero data — no full-size mask pass
    order_pad = jnp.where(
        jnp.arange(rows) < n_det, order_dev[:rows], jnp.int32(iy.shape[0])
    )
    iy_r = jnp.take(
        jnp.concatenate([iy, jnp.full((1, n_t), -1, iy.dtype)]), order_pad, axis=0
    )
    ix_r = jnp.take(
        jnp.concatenate([ix, jnp.full((1, n_t), -1, ix.dtype)]), order_pad, axis=0
    )
    d_r = jnp.take(
        jnp.concatenate([data, jnp.zeros((1, n_t), data.dtype)]), order_pad, axis=0
    )
    if pad_t:
        iy_r = jnp.pad(iy_r, ((0, 0), (0, pad_t)), constant_values=-1)
        ix_r = jnp.pad(ix_r, ((0, 0), (0, pad_t)), constant_values=-1)
        d_r = jnp.pad(d_r, ((0, 0), (0, pad_t)), mode="edge")

    ky = jnp.arange(wy, dtype=jnp.int32)
    kx = jnp.arange(wx, dtype=jnp.int32)
    r_iota = jnp.arange(r_max, dtype=jnp.int32)
    big = jnp.int32(1 << 30)

    def chunk_body(carry, c):
        m, lost = carry
        yb = jax.lax.dynamic_slice_in_dim(iy_r, c * chunk, chunk, axis=1)
        xb = jax.lax.dynamic_slice_in_dim(ix_r, c * chunk, chunk, axis=1)
        d_c = jax.lax.dynamic_slice_in_dim(d_r, c * chunk, chunk, axis=1)
        yb = yb.reshape(nb, db, chunk)
        xb = xb.reshape(nb, db, chunk)
        d_c = d_c.reshape(nb, db, chunk)

        valid = (yb >= 0) & (xb >= 0)
        oy_c = jnp.clip(jnp.where(valid, yb, big).min(axis=(1, 2)), 0, n_y - wy)
        ox_c = jnp.clip(jnp.where(valid, xb, big).min(axis=(1, 2)), 0, n_x - wx)
        l_y = jnp.where(valid, yb - oy_c[:, None, None], -1)
        l_x = jnp.where(valid, xb - ox_c[:, None, None], -1)
        win_lost = valid & ((l_y >= wy) | (l_x >= wx))
        l_y = jnp.where(win_lost, -1, l_y)
        l_x = jnp.where(win_lost, -1, l_x)

        # runs: new run at each segment boundary or pixel change; off-map
        # samples (packed -1) coalesce into runs that the hats skip
        p = jnp.where(l_y >= 0, l_y * jnp.int32(wx) + l_x, -1)
        p = p.reshape(nb, db, n_seg, seg)
        l_y = l_y.reshape(nb, db, n_seg, seg)
        l_x = l_x.reshape(nb, db, n_seg, seg)
        change = jnp.concatenate(
            [jnp.ones((nb, db, n_seg, 1), bool), p[..., 1:] != p[..., :-1]], axis=-1
        )
        slot = jnp.cumsum(change.astype(jnp.int32), axis=-1) - 1
        slot_lost = (slot >= r_max) & (p >= 0)

        # row-shifted (default): subtract each detector ROW's chunk mean
        # so the bf16 contraction rounds only the in-row residual (a
        # per-block mean leaves the detector-to-detector offset spread
        # in the residual — measured 4.5e-4 relative vs this scheme's
        # ~1e-5); the row means are restored EXACTLY through a
        # hi/lo-split (mu_row * run-length) channel pair riding the same
        # hats. precision="hilo" skips the shift and splits the raw run
        # sums instead — zero data stays EXACTLY zero (no restore
        # residue), which CG solvers need (bin_runchunk's hilo note).
        if precision == "hilo":
            mu_d = jnp.zeros(d_c.shape[:2], d_c.dtype)
        else:
            mu_d = d_c.mean(axis=2)  # (nb, db)
        ds = (d_c - mu_d[:, :, None]).reshape(nb, db, n_seg, seg)

        # fused one-hot multiply-reduce over run slots (the compare
        # rides inside the reduction; no materialized one-hot): shifted
        # run sums, run lengths, and start offsets in one pass
        hat = (slot[..., None] == r_iota).astype(jnp.float32)
        feats = jnp.stack(
            [
                ds,
                jnp.where(p >= 0, 1.0, 0.0),
                jnp.where(change, l_y, 0).astype(jnp.float32),
                jnp.where(change, l_x, 0).astype(jnp.float32),
            ],
            axis=0,
        )  # (4, nb, db, S, seg)
        out = (feats[..., None] * hat[None]).sum(axis=4)  # (4, nb, db, S, R)
        runsum, cnt, r_ly, r_lx = out[0], out[1], out[2], out[3]
        empty = cnt <= 0
        r_ly = jnp.where(empty, -1, r_ly.astype(jnp.int32))
        r_lx = jnp.where(empty, -1, r_lx.astype(jnp.int32))

        wY = (r_ly[..., None] == ky).astype(jnp.bfloat16)  # (nb, db, S, R, wy)
        wX = (r_lx[..., None] == kx).astype(jnp.bfloat16)
        if precision == "hilo":
            hi, lo = split_bf16(runsum)
            parts = jnp.stack([hi, lo, cnt.astype(jnp.bfloat16)])
        else:
            mc = mu_d[:, :, None, None] * cnt  # (nb, db, S, R) restore weights
            mc_hi, mc_lo = split_bf16(mc)
            parts = jnp.stack(
                [runsum.astype(jnp.bfloat16), cnt.astype(jnp.bfloat16), mc_hi, mc_lo]
            )
        win = jnp.einsum(
            "bdsry,bdsrx,mbdsr->mbyx", wY, wX, parts,
            preferred_element_type=jnp.float32,
        )
        # restore (exact: the hi/lo pair carries ~16 bits); the count
        # window IS the hit-map contribution
        if precision == "hilo":
            win = jnp.stack([win[0] + win[1], win[2]])
        else:
            win = jnp.stack([win[0] + win[2] + win[3], win[1]])

        # vectorized placement (bin_runchunk pattern): pad each block's
        # window to the map and roll to its (clipped) origin
        full = jnp.pad(win, ((0, 0), (0, 0), (0, n_y - wy), (0, n_x - wx)))
        org_c = jnp.stack([oy_c, ox_c], axis=-1)
        placed = jax.vmap(
            lambda w, o: jnp.roll(w, shift=(o[0], o[1]), axis=(-2, -1)),
            in_axes=(1, 0), out_axes=1,
        )(full, org_c)
        new_lost = lost + (
            win_lost.sum() + jnp.where(slot_lost, 1, 0).sum()
        ).astype(jnp.float32)
        return (m + placed.sum(axis=1), new_lost), ()

    m0 = jnp.zeros((2, n_y, n_x), dtype=jnp.float32)
    (m, lost), _ = jax.lax.scan(
        chunk_body, (m0, jnp.float32(0.0)), jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return m[0], m[1], lost


def project_runs_traced(
    map_img,
    iy,
    ix,
    order_dev,
    inv_order_dev,
    *,
    n_det: int,
    det_block: int,
    n_blocks: int,
    n_chunks: int,
    chunk: int,
    seg: int,
    r_max: int,
    wy: int,
    wx: int,
    n_y: int,
    n_x: int,
):
    """P m from TRACED pixel ids: sample (d, t) <- map_img[iy, ix]
    (0 for off-map), the streamed twin of `project_runchunk` for the
    streaming ML mapper, sharing `bin_runs_traced`'s in-scan run
    extraction so P stays two MXU hat passes + a fused run->sample
    expansion instead of an elementwise gather.

    Returns (n_det, n_chunks * chunk) samples in the ORIGINAL detector
    order (trim the time pad yourself). Runs past `r_max` slots produce
    ZERO samples — callers must bound r_max exactly as for
    `bin_runs_traced` (the binner's lost counter polices the same bound).
    Precision ~2^-16 relative (hi/lo window split). Pure jnp; call
    under jit."""
    from .binning import blockify_ids

    n_seg = chunk // seg
    nb, db = n_blocks, det_block

    iy_b = blockify_ids(iy, order_dev, n_det, db, nb, n_chunks, chunk)
    ix_b = blockify_ids(ix, order_dev, n_det, db, nb, n_chunks, chunk)
    valid_all = (iy_b >= 0) & (ix_b >= 0)
    big = jnp.int32(1 << 30)
    oy = jnp.clip(jnp.where(valid_all, iy_b, big).min(axis=(1, 3)), 0, n_y - wy)
    ox = jnp.clip(jnp.where(valid_all, ix_b, big).min(axis=(1, 3)), 0, n_x - wx)

    maps2 = jnp.stack(split_bf16(map_img))  # (2, n_y, n_x)

    ky = jnp.arange(wy, dtype=jnp.int32)
    kx = jnp.arange(wx, dtype=jnp.int32)
    r_iota = jnp.arange(r_max, dtype=jnp.int32)

    def chunk_body(_, c):
        yb = jax.lax.dynamic_slice_in_dim(iy_b, c, 1, axis=2)[:, :, 0]
        xb = jax.lax.dynamic_slice_in_dim(ix_b, c, 1, axis=2)[:, :, 0]
        oy_c = jax.lax.dynamic_slice_in_dim(oy, c, 1, axis=1)[:, 0]
        ox_c = jax.lax.dynamic_slice_in_dim(ox, c, 1, axis=1)[:, 0]
        valid = (yb >= 0) & (xb >= 0)
        l_y = jnp.where(valid, yb - oy_c[:, None, None], -1)
        l_x = jnp.where(valid, xb - ox_c[:, None, None], -1)
        oob = valid & ((l_y >= wy) | (l_x >= wx))
        l_y = jnp.where(oob, -1, l_y)
        l_x = jnp.where(oob, -1, l_x)
        p = jnp.where(l_y >= 0, l_y * jnp.int32(wx) + l_x, -1)
        p = p.reshape(nb, db, n_seg, seg)
        l_y = l_y.reshape(nb, db, n_seg, seg)
        l_x = l_x.reshape(nb, db, n_seg, seg)
        change = jnp.concatenate(
            [jnp.ones((nb, db, n_seg, 1), bool), p[..., 1:] != p[..., :-1]], axis=-1
        )
        slot = jnp.cumsum(change.astype(jnp.int32), axis=-1) - 1
        hat = (slot[..., None] == r_iota).astype(jnp.float32)
        feats = jnp.stack(
            [
                jnp.where(change, l_y, 0).astype(jnp.float32),
                jnp.where(change, l_x, 0).astype(jnp.float32),
                jnp.where(p >= 0, 1.0, 0.0),
            ],
            axis=0,
        )
        out = (feats[..., None] * hat[None]).sum(axis=4)  # (3, nb, db, S, R)
        r_ly, r_lx, cnt = out[0], out[1], out[2]
        empty = cnt <= 0
        r_ly = jnp.where(empty, -1, r_ly.astype(jnp.int32))
        r_lx = jnp.where(empty, -1, r_lx.astype(jnp.int32))

        def win1(o):
            return jax.lax.dynamic_slice(maps2, (0, o[0], o[1]), (2, wy, wx))

        W = jax.lax.map(win1, jnp.stack([oy_c, ox_c], axis=-1))  # (nb, 2, wy, wx)
        wY = (r_ly[..., None] == ky).astype(jnp.bfloat16)  # (nb, db, S, R, wy)
        wX = (r_lx[..., None] == kx).astype(jnp.bfloat16)
        tmp = jnp.einsum("bdsry,bfyx->bfdsrx", wY, W, preferred_element_type=jnp.float32)
        val2 = jnp.einsum(
            "bdsrx,bfdsrx->bfdsr", wX.astype(jnp.float32), tmp,
            preferred_element_type=jnp.float32,
        )
        val = val2[:, 0] + val2[:, 1]  # (nb, db, S, R)
        # fused run -> sample expansion: each sample reads its slot's value
        samp = (val[..., None, :] * (slot[..., None] == r_iota)).sum(axis=-1)
        return 0, samp.reshape(nb * db, chunk)

    _, out = jax.lax.scan(chunk_body, 0, jnp.arange(n_chunks, dtype=jnp.int32))
    out = jnp.moveaxis(out, 0, 1).reshape(nb * db, n_chunks * chunk)
    return jnp.take(out, inv_order_dev, axis=0)


def project_runchunk(
    maps,
    plan: RunChunkBinPlan,
    e_idx=None,
    run_ly=None,
    run_lx=None,
    origins=None,
):
    """Transpose of the run plan's pointing: sample (f, d, t) <-
    maps[f, iy[d,t], ix[d,t]] (0 for off-map samples), returned in the
    ORIGINAL detector order with the true n_t.

    The static runs turn P into one-hot contractions instead of an
    elementwise gather (the reference, maria/mappers/ml_mapper.py:323-327,
    does it as a torch sparse matvec): per (det-block, time-chunk), run VALUES are the map
    window contracted with the SAME one-hot hats the binning builds
    (two bf16 passes on a hi/lo window split, ~2^-16 relative), and
    samples re-expand from their run values through the membership step
    matrix e_{r-1} < t <= e_r built from the static run-end indices (a
    fused multiply-reduce — each sample belongs to exactly one run).

    `maps` is (n_y, n_x) or channel-stacked (n_fr, n_y, n_x). Pass
    `plan.device_args()[:4]` through the keyword arguments under jit
    (closure constants of that size blow the remote compile request).
    Pure jnp; call under jit.
    """
    e_idx = jnp.asarray(plan.e_idx) if e_idx is None else e_idx
    run_ly = jnp.asarray(plan.run_ly) if run_ly is None else run_ly
    run_lx = jnp.asarray(plan.run_lx) if run_lx is None else run_lx
    origins = jnp.asarray(plan.origins) if origins is None else origins

    squeeze = maps.ndim == 2
    if squeeze:
        maps = maps[None]
    n_fr = maps.shape[0]
    nb, db, C, R = plan.n_blocks, plan.det_block, plan.chunk, plan.r_max
    seg = plan.seg
    n_seg = C // seg

    # hi/lo split once: the bf16 hat passes round each window value to
    # ~2^-16 relative (two bf16 mantissas), matching bin_runchunk("hilo")
    maps2 = jnp.concatenate(split_bf16(maps), axis=0)  # (2 n_fr, n_y, n_x)

    ky = jnp.arange(plan.wy, dtype=jnp.int32)
    kx = jnp.arange(plan.wx, dtype=jnp.int32)
    t_iota = jnp.arange(seg, dtype=jnp.int32)

    def chunk_body(_, args):
        e_c, ly_c, lx_c, org_c = args  # (nb, db, S, R); org_c (nb, 2)

        def win1(o):
            return jax.lax.dynamic_slice(
                maps2, (0, o[0], o[1]), (2 * n_fr, plan.wy, plan.wx)
            )

        W = jax.lax.map(win1, org_c)  # (nb, 2 n_fr, wy, wx) bf16
        wY = (ly_c.astype(jnp.int32)[..., None] == ky).astype(jnp.bfloat16)
        wX = (lx_c.astype(jnp.int32)[..., None] == kx).astype(jnp.bfloat16)
        # contract y on the MXU (rows = db*S*R), then x as a fused
        # multiply-reduce; off-map runs (ly = -1) hit no hat row -> 0
        tmp = jnp.einsum(
            "bdsry,bfyx->bfdsrx", wY, W, preferred_element_type=jnp.float32
        )
        val2 = jnp.einsum(
            "bdsrx,bfdsrx->bfdsr", wX.astype(jnp.float32), tmp,
            preferred_element_type=jnp.float32,
        )
        val = val2[:, :n_fr] + val2[:, n_fr:]  # (nb, n_fr, db, S, R)
        # membership: in-segment position t belongs to run r iff
        # e_{r-1} < t <= e_r (empty tail slots pin e to seg-1 and have
        # e_prev = seg-1 -> empty interval)
        e32 = e_c.astype(jnp.int32)
        prev = jnp.concatenate(
            [jnp.full(e32.shape[:-1] + (1,), -1, jnp.int32), e32[..., :-1]], axis=-1
        )
        memb = (
            (t_iota[:, None] > prev[..., None, :])
            & (t_iota[:, None] <= e32[..., None, :])
        ).astype(jnp.float32)  # (nb, db, S, seg, R)
        # HIGHEST: `val` carries the full hi+lo value; a default-precision
        # f32 dot may round it to TF32 (10 mantissa bits), and P must stay
        # the transpose of bin_runchunk's P^T for CG to converge
        samp = jnp.einsum("bdscr,bfdsr->fbdsc", memb, val,
                          precision=jax.lax.Precision.HIGHEST)
        return 0, samp.reshape(n_fr, nb * db, C)

    xs = (
        jnp.moveaxis(e_idx, 2, 0),
        jnp.moveaxis(run_ly, 2, 0),
        jnp.moveaxis(run_lx, 2, 0),
        jnp.moveaxis(origins, 1, 0),
    )
    _, out = jax.lax.scan(chunk_body, 0, xs)
    # (nc, n_fr, nb*db, C) -> (n_fr, nb*db, nc*C) -> true n_t, orig order
    out = jnp.moveaxis(out, 0, 2).reshape(n_fr, nb * db, plan.n_chunks * C)
    out = out[..., : plan.n_t]
    inv = np.zeros(plan.n_det, np.int32)
    inv[plan.order[: plan.n_det]] = np.arange(plan.n_det, dtype=np.int32)
    out = jnp.take(out, jnp.asarray(inv), axis=1)
    return out[0] if squeeze else out


def make_sibling_run_stats(
    order_dev, *, n_det, det_block, n_blocks, n_chunks, chunk, seg, n_x
):
    """ONE jitted stats program reusable across sibling time blocks of
    an observation: (iy, ix) -> (oy (nb, nc), hy, ox, hx, max_runs).
    The streaming executor's resident-plan setup calls it once per
    block; `make_runchunk_bin_plan_on_device` builds the same pass
    inline (single-TOD case). Keep the two in sync."""
    n_seg = chunk // seg

    @jax.jit
    def stats(iy, ix):
        iy_b = blockify_ids(iy, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)
        ix_b = blockify_ids(ix, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)
        big = jnp.int32(1 << 30)

        def body(_, c):
            yb = jax.lax.dynamic_slice_in_dim(iy_b, c, 1, axis=2)[:, :, 0]
            xb = jax.lax.dynamic_slice_in_dim(ix_b, c, 1, axis=2)[:, :, 0]
            valid = (yb >= 0) & (xb >= 0)
            oy_c = jnp.minimum(jnp.where(valid, yb, big).min(axis=(1, 2)),
                               jnp.where(valid, yb, -1).max(axis=(1, 2)))
            hy_c = jnp.where(valid, yb, -1).max(axis=(1, 2))
            ox_c = jnp.minimum(jnp.where(valid, xb, big).min(axis=(1, 2)),
                               jnp.where(valid, xb, -1).max(axis=(1, 2)))
            hx_c = jnp.where(valid, xb, -1).max(axis=(1, 2))
            pix = jnp.where(valid, yb * jnp.int32(n_x) + xb, -1)
            pix_s = pix.reshape(pix.shape[:-1] + (n_seg, seg))
            change = jnp.concatenate(
                [jnp.ones(pix_s.shape[:-1] + (1,), bool),
                 pix_s[..., 1:] != pix_s[..., :-1]],
                axis=-1,
            )
            return 0, (oy_c, hy_c, ox_c, hx_c, change.sum(axis=-1).max())

        _, (oy, hy, ox, hx, nr) = jax.lax.scan(
            body, 0, jnp.arange(n_chunks, dtype=jnp.int32)
        )
        return oy.T, hy.T, ox.T, hx.T, nr.max()

    return stats


def make_sibling_run_extract(
    order_dev, *, n_det, det_block, n_blocks, n_chunks, chunk, seg, r_max,
    wy, wx, n_y, n_x
):
    """ONE jitted extraction program reusable across sibling time
    blocks with a UNIFORM (wy, wx, r_max) geometry (fixed from the max
    over all blocks' stats): (iy, ix, oy_d, ox_d) ->
    (e, run_ly, run_lx (nb, db, nc, S, R) int8/int32,
     wcnt (nb, nc, wy, wx) f32, hits (n_y, n_x) f32).
    The body is `make_runchunk_bin_plan_on_device`'s extraction scan
    plus an in-jit placed hits map (the host loop there would read the
    wcnt windows back per block). Keep the two in sync."""
    n_seg = chunk // seg
    idx_dtype = jnp.int8 if seg <= 128 and max(wy, wx) < 127 else jnp.int32

    @jax.jit
    def extract(iy, ix, oy_d, ox_d):
        iy_b = blockify_ids(iy, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)
        ix_b = blockify_ids(ix, order_dev, n_det, det_block, n_blocks, n_chunks, chunk)

        t_iota = jnp.arange(seg, dtype=jnp.int32)
        r_iota = jnp.arange(r_max, dtype=jnp.int32)

        def body(_, cb):
            c, b = cb // n_blocks, cb % n_blocks
            yb = jax.lax.dynamic_slice(iy_b, (b, 0, c, 0), (1, det_block, 1, chunk))
            xb = jax.lax.dynamic_slice(ix_b, (b, 0, c, 0), (1, det_block, 1, chunk))
            yb = yb[0, :, 0]
            xb = xb[0, :, 0]
            valid = (yb >= 0) & (xb >= 0)
            oy_cb = jax.lax.dynamic_slice(oy_d, (b, c), (1, 1))[0, 0]
            ox_cb = jax.lax.dynamic_slice(ox_d, (b, c), (1, 1))[0, 0]
            l_y = jnp.where(valid, yb - oy_cb, -1)
            l_x = jnp.where(valid, xb - ox_cb, -1)
            p = jnp.where(valid, l_y * jnp.int32(wx) + l_x, -1)
            p = p.reshape(det_block, n_seg, seg)
            l_y = l_y.reshape(det_block, n_seg, seg)
            l_x = l_x.reshape(det_block, n_seg, seg)
            change = jnp.concatenate(
                [jnp.ones((det_block, n_seg, 1), bool), p[..., 1:] != p[..., :-1]],
                axis=-1,
            )
            slot = jnp.cumsum(change.astype(jnp.int32), axis=-1) - 1
            is_end = jnp.concatenate(
                [change[..., 1:], jnp.ones((det_block, n_seg, 1), bool)], axis=-1
            )
            onehot = (slot[..., None] == r_iota).astype(jnp.float32)
            feats = jnp.stack(
                [
                    jnp.where(is_end, t_iota, 0).astype(jnp.float32),
                    jnp.where(change, l_y, 0).astype(jnp.float32),
                    jnp.where(change, l_x, 0).astype(jnp.float32),
                    jnp.ones((det_block, n_seg, seg), jnp.float32),
                ],
                axis=0,
            )
            out = jnp.einsum("dscr,mdsc->mdsr", onehot, feats)
            e = out[0].astype(jnp.int32)
            r_ly = out[1].astype(jnp.int32)
            r_lx = out[2].astype(jnp.int32)
            cnt = out[3]
            empty = cnt <= 0
            e = jnp.where(empty, seg - 1, e)
            r_ly = jnp.where(empty, -1, r_ly)
            r_lx = jnp.where(empty, -1, r_lx)
            hy = (r_ly[..., None] == jnp.arange(wy)).astype(jnp.float32)
            hx = (r_lx[..., None] == jnp.arange(wx)).astype(jnp.float32)
            w = jnp.einsum("dsry,dsrx,dsr->yx", hy, hx, cnt)
            return 0, (e.astype(idx_dtype), r_ly.astype(idx_dtype),
                       r_lx.astype(idx_dtype), w)

        _, (e, r_ly, r_lx, w) = jax.lax.scan(
            body, 0, jnp.arange(n_chunks * n_blocks, dtype=jnp.int32)
        )

        def _unflat(a):
            return jnp.moveaxis(
                a.reshape(n_chunks, n_blocks, det_block, n_seg, r_max), 0, 2
            )

        e, r_ly, r_lx = _unflat(e), _unflat(r_ly), _unflat(r_lx)
        w = jnp.moveaxis(w.reshape(n_chunks, n_blocks, wy, wx), 0, 1)

        # placed hits: the block's key-independent weight-map term
        full = jnp.pad(
            w.reshape(n_blocks * n_chunks, wy, wx),
            ((0, 0), (0, n_y - wy), (0, n_x - wx)),
        )
        org = jnp.stack(
            [oy_d.reshape(-1), ox_d.reshape(-1)], axis=-1
        )  # (nb * nc, 2) — same (b, c) raveling as w
        placed = jax.vmap(
            lambda win, o: jnp.roll(win, shift=(o[0], o[1]), axis=(-2, -1))
        )(full, org)
        hits = placed.sum(axis=0)
        return e, r_ly, r_lx, w, hits

    return extract
