"""Bounded-memory TOD synthesis: arbitrary observation length at
O(block) fine-rate memory.

The reference's flagship claim is "arbitrarily long periods of
atmospheric evolution" (maria README.rst:34-36), backed by an O(n) AR
extrusion and dask-lazy TOD fields (maria/tod/tod.py:63). The memory
wall in a device build is the FINE-rate (n_det, n_t) fields — AtLAST's
50k detectors for one hour at 50 Hz is ~36 GB/field in f32, past one
device's memory. The coarse-rate stages are ~upsample_ratio x smaller and cheap to
keep whole.

So the executor splits the fused program at the coarse/fine boundary:

- ONE whole-observation coarse stage (`TODProgram._loadings(upto=
  "coarse")`): pointing, screen synthesis, AR extrusion, LOS sampling,
  bandpass integration -> loading_c (n_det, n_tc). Identical numbers to
  the batch program (same key, same ops).
- FINE-rate synthesis in fixed blocks of `block_tc` coarse cells: the
  phase-stencil cubic upsample runs per block on a haloed coarse slice
  (bitwise-equal to the full upsample — tested), sky stages (cmb=/
  input_map=) are sampled along the block's exact pointing with the
  batch program's calibration tables, detector noise comes from the
  streaming pink cascade (noise/streaming.py), gains multiply, and each
  block is binned straight into carried (map_sum, map_wgt)
  accumulators. Nothing of size (n_det, n_t) ever exists.

Chunk-invariance: every block depends only on (carried state, block
index), so any grouping of blocks per dispatch gives identical results
(`run(group_size=1) == run(group_size=n_blocks)`, tested exactly).

The noise model is the streaming cascade, not the batch FFT: the two
match in PSD (tested) but not sample-by-sample — a streaming generator
cannot reproduce a circulant whole-observation FFT draw.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..coords.transforms import offsets_to_phi_theta, phi_theta_to_offsets_jit
from ..noise.streaming import StreamingBandNoise
from .binning import bin_scatter

logger = logging.getLogger("maria_tpu")

__all__ = [
    "StreamingExecutor",
    "upsample_block_phases",
    "pad_coarse_for_blocks",
    "StreamingResult",
]


def pad_coarse_for_blocks(values, block_tc: int, n_blocks: int):
    """Clamp-pad a coarse (..., n_c) series for `upsample_block_phases`:
    one left edge clamp plus enough right clamps that the LAST block's
    dynamic_slice never hits the array end (dynamic_slice clamps the
    start index, which would silently shift the stencil)."""
    n_c = values.shape[-1]
    n_right = n_blocks * block_tc + 2 - n_c
    right = jnp.repeat(values[..., -1:], n_right, axis=-1)
    return jnp.concatenate([values[..., :1], values, right], axis=-1)


def pad_coarse_for_blocks_ext(values, block_tc: int, n_blocks: int):
    """Like `pad_coarse_for_blocks` but with TWO left clamps and extra
    right clamps, for `upsample_block_ext`'s one-cell halo."""
    n_c = values.shape[-1]
    n_right = n_blocks * block_tc + 3 - n_c
    right = jnp.repeat(values[..., -1:], n_right, axis=-1)
    return jnp.concatenate([values[..., :1], values[..., :1], values, right], axis=-1)


def _stencil_cells(sl, n_cells: int, ratio: int, n_c: int, kind: str):
    """Catmull-Rom (or linear) phase stencil over `n_cells` coarse cells
    given the slice [p0 of cell 0 ... p3 of cell n_cells-1] — shared
    with ops/interp.upsample_time_phases (bitwise-identical weights and
    contraction) so the blockwise variants cannot drift from the full
    upsample."""
    from .interp import _phase_stencil_matrix, phase_major_cells

    if kind == "linear" or n_c < 4:
        taps = [sl[..., 1 : n_cells + 1], sl[..., 2 : n_cells + 2]]
    else:
        taps = [sl[..., k : n_cells + k] for k in range(4)]
    C = _phase_stencil_matrix(ratio, "linear" if (kind == "linear" or n_c < 4) else "cubic")
    out = phase_major_cells(taps, C, sl.dtype)
    return out.reshape(*out.shape[:-2], n_cells * ratio)


def upsample_block_ext(values_pad2, c0, block_tc: int, ratio: int, n_c: int, v_last, kind="cubic"):
    """Blockwise upsample over cells [c0 - 1, c0 + block_tc + 1): one
    coarse-cell halo on each side of the block, for stages (like the
    continuous-integration kernel) that need fine-sample context across
    block boundaries. `values_pad2` comes from
    `pad_coarse_for_blocks_ext`. Interior fine values are bitwise-equal
    to `upsample_block_phases`; halo cells beyond the global fine range
    are junk that callers must clamp (see the kernel helper)."""
    n_cells = block_tc + 2
    # cell (c0 - 1)'s p0 = v[c0 - 2] lives at pad2 index c0 (two clamps)
    sl = jax.lax.dynamic_slice_in_dim(values_pad2, c0, n_cells + 3, axis=-1)
    out = _stencil_cells(sl, n_cells, ratio, n_c, kind)
    g = (c0 - 1) * ratio + jnp.arange(n_cells * ratio)
    return jnp.where(g >= (n_c - 1) * ratio, v_last[..., None], out)


def upsample_block_phases(values_pad, c0, block_tc: int, ratio: int, n_c: int, v_last, kind="cubic"):
    """Blockwise `upsample_time_phases`, bitwise-equal on the block.

    `values_pad` is the coarse array padded once OUTSIDE the block loop:
    [v[0], v..., v[-1], v[-1]] (one left clamp, two right clamps), shape
    (..., n_c + 3). The block covers coarse cells [c0, c0 + block_tc);
    fine samples past cell n_c - 2 replicate the last coarse value,
    matching the full version's tail extension."""
    sl = jax.lax.dynamic_slice_in_dim(values_pad, c0, block_tc + 3, axis=-1)
    out = _stencil_cells(sl, block_tc, ratio, n_c, kind)
    # tail: fine j >= (n_c - 1) * ratio repeats the last coarse value
    g = c0 * ratio + jnp.arange(block_tc * ratio)
    return jnp.where(g >= (n_c - 1) * ratio, v_last[..., None], out)


@dataclass
class StreamingResult:
    """Accumulated products of a streaming run (units: pW)."""

    map_sum: np.ndarray  # (n_y, n_x) sum of TOD power per pixel
    map_wgt: np.ndarray  # (n_y, n_x) hit counts
    n_samples: int
    n_x: int
    n_y: int
    center: tuple
    res: float
    # per-band Welch noise spectra (ML-mapper noise statistics without
    # ever holding the full TOD): mean detrended+Hann periodogram over
    # blocks and band detectors, one-sided, pW^2/Hz
    psd_freqs: np.ndarray = None  # (B//2 + 1,)
    psds: list = None  # [(n_freq,) per band]

    @property
    def map(self):
        with np.errstate(invalid="ignore"):
            return np.where(self.map_wgt > 0, self.map_sum / self.map_wgt, np.nan)


class StreamingExecutor:
    """Time-blocked executor over a TODProgram (see module docstring).

    Streams the full pipeline: atmosphere + noise + gains, and — when
    `cmb=`/`input_map=` are given — the sky stages too, sampled per
    block from the same calibration tables and smoothed channel maps the
    batch program bakes into static timelines (matches the batch output;
    tested) — including time-evolving input maps, whose frame-blend
    weights stream to the blocks as two more pointing-track arrays. The
    program itself must be built WITHOUT cmb/input_map.
    """

    def __init__(
        self,
        program,
        obs=None,
        block_tc="auto",
        n_x: int = 128,
        n_y: int = 128,
        res: float = None,
        center: tuple = None,
        T_ref: float = None,
        cmb=None,
        input_map=None,
        map_kwargs: dict = None,
        frame: str = "az/el",
    ):
        if program.upsample_ratio is None:
            raise ValueError(
                "StreamingExecutor needs an integer coarse/fine upsample ratio "
                "(aligned uniform grids); this program has none."
            )
        if any(b.cmb_samples is not None or b.map_stages for b in program.bands):
            raise NotImplementedError(
                "This program carries whole-observation static sky timelines; "
                "build it without cmb/input_map and pass cmb=/input_map= to the "
                "executor instead — it samples the sky per block."
            )
        if (cmb is not None or input_map is not None) and obs is None:
            raise ValueError("streaming sky stages need the Observation (obs=)")
        if frame not in ("az/el", "ra/dec"):
            raise ValueError(f"frame must be 'az/el' or 'ra/dec', not '{frame}'")
        if frame == "ra/dec" and obs is None:
            raise ValueError("binning in ra/dec needs the Observation (obs=)")
        self.frame = frame
        self.program = program
        self.r = int(program.upsample_ratio)
        if block_tc == "auto":
            # throughput-oriented default: the LARGEST block whose
            # fine-rate working set (~8 live (n_det, B) f32 buffers:
            # upsample stencil, sky/cal factors, noise cascade, total,
            # binning ids/intermediates) fits a device-memory budget —
            # tiny blocks are flat-memory but dispatch/scan-overhead-
            # bound. Budget: 1/8 of the device's memory (2 GB on the
            # CPU); override MARIA_TPU_STREAM_HBM_GB.
            import os

            from ..backend import memory_budget

            budget = (float(os.environ["MARIA_TPU_STREAM_HBM_GB"]) * 1e9
                      if os.environ.get("MARIA_TPU_STREAM_HBM_GB")
                      else memory_budget(1 / 8, 2e9))
            per_cell = 8 * len(program.offsets) * self.r * 4
            n_tc = -(-len(program.t_fine) // self.r)
            block_tc = int(np.clip(budget // max(per_cell, 1), 16, max(n_tc, 16)))
            if len(program.offsets) > 4096:
                # large arrays bin by one-hot contractions in-scan; the
                # per-block window AREA grows with block duration and
                # pushes the one-hot passes past the row-bound regime,
                # so longer blocks stream slower despite fewer scan steps
                block_tc = min(block_tc, 128)
        self.block_tc = int(block_tc)
        self.B = self.block_tc * self.r
        self.n_t = len(program.t_fine)
        self.n_c = len(program.t_coarse)
        self.n_det = len(program.offsets)
        self.n_real_det = getattr(program, "n_real_det", self.n_det)
        self.n_blocks = -(-self.n_t // self.B)
        duration = float(program.t_fine[-1] - program.t_fine[0]) + 1.0
        T_ref = T_ref or max(4096.0, 2.0 * duration)

        # fine boresight track (exact pointing, host; O(n_t) scalars)
        if obs is not None:
            bs_az_f = np.asarray(obs.boresight.az, dtype=np.float32)
            bs_el_f = np.asarray(obs.boresight.el, dtype=np.float32)
        else:  # fall back to upsampling the program's coarse track
            from .interp import upsample_time

            t_c = jnp.asarray(program.t_coarse, dtype=jnp.float32)
            t_f = jnp.asarray(program.t_fine, dtype=jnp.float32)
            bs_az_f = np.asarray(upsample_time(jnp.asarray(program.bs_az_coarse), t_c, t_f))
            bs_el_f = np.asarray(upsample_time(jnp.asarray(program.bs_el_coarse), t_c, t_f))
        pad_f = self.n_blocks * self.B - self.n_t
        self.bs_az_f = np.pad(bs_az_f, (0, pad_f), mode="edge")
        self.bs_el_f = np.pad(bs_el_f, (0, pad_f), mode="edge")

        # binning-frame tracks (exact pointing; O(n_t) scalars on host)
        self.bs_ra_f = self.bs_dec_f = self.q_f = None
        if obs is not None and frame == "ra/dec":
            self._load_radec_tracks(obs, pad_f)

        # map geometry (defaults sized from the detector hull like bench)
        self.n_x, self.n_y = int(n_x), int(n_y)
        if frame == "ra/dec":
            phi_f, theta_f = self.bs_ra_f, self.bs_dec_f
        else:
            phi_f, theta_f = self.bs_az_f, self.bs_el_f
        c0 = center[0] if center else float(np.mean(phi_f))
        c1 = center[1] if center else float(np.mean(theta_f))
        self.center = (c0, c1)
        if res is None:
            # bound every det x time sample: all detectors x a coarse
            # boresight subsample, with margin for the skipped samples.
            # This one-off setup math runs on the host CPU backend: run
            # eagerly on the device, its ~27 jnp primitives would each
            # compile and dispatch a tiny executable for a result the
            # host reads straight back.
            step = max(1, len(phi_f) // 1024)
            o = program.offsets.astype(np.float32)
            if frame == "ra/dec":
                q = self.q_f[::step]
                cq, sq = np.cos(q), np.sin(q)
                det_offs = np.stack(
                    [o[:, :1] * cq - o[:, 1:] * sq, o[:, :1] * sq + o[:, 1:] * cq], axis=-1
                )
            else:
                det_offs = o[:, None, :]
            try:
                host = jax.devices("cpu")[0]
            except RuntimeError:
                host = None
            with jax.default_device(host):
                pt = np.asarray(
                    offsets_to_phi_theta(
                        jnp.asarray(det_offs), jnp.asarray(phi_f[::step]),
                        jnp.asarray(theta_f[::step]),
                    )
                )
                offs = np.asarray(phi_theta_to_offsets_jit(jnp.asarray(pt), c0, c1))
            half = float(np.abs(offs).max()) * 1.05 + 1e-6
            res = 2 * half / self.n_x
        self.res = float(res)

        self.noise_models = [
            StreamingBandNoise(
                program.sample_rate, b.knee, basis=b.noise_basis,
                corr_prop=b.corr_prop, T_ref=T_ref,
            )
            for b in program.bands
        ]
        self.sky = None
        self._run_params = None  # set by _setup_blocked_binning
        self._map_fi_f = self._map_whi_f = None
        if cmb is not None or input_map is not None:
            self._build_sky(obs, cmb, input_map, map_kwargs or {}, pad_f)
        self._block_fn_cache = {}
        self._coarse_jit = None
        self._bin_plan_cache = "unset"  # lazy: see the _bin_plan property
        self._resident_cache = "unset"  # lazy: see the _resident property

    def _build_sky(self, obs, cmb, input_map, map_kwargs, pad_f: int):
        """Host setup for per-block sky sampling: the SAME calibration
        tables and smoothed channel maps the batch program bakes into
        static timelines (program.py build_tod_program), minus the
        (n_det, n_t) timelines themselves — those are evaluated
        in-program, block by block."""
        from ..beam import compute_angular_fwhm
        from ..sim.cmb import cmb_power_tables
        from ..sim.map import check_map_observable, map_transmission_table
        from ..units import Quantity
        from .interp import make_table_eval

        atm = obs.atmosphere
        T_base = float(atm.weather.temperature[0])
        stokes_weight = np.asarray(obs.instrument.dets.stokes_weight(), dtype=np.float32)
        sky = {"cmb": None, "map": None, "bands": [], "need_radec": False}

        if cmb is not None:
            if cmb.frame not in ("galactic", "ra/dec"):
                raise ValueError(f"Cannot stream a CMB in frame '{cmb.frame}'.")
            sky["cmb"] = {
                "nside": cmb.nside,
                "frame": cmb.frame,
                "fields": np.asarray(cmb.data[:, 0, 0], dtype=np.float32),
                "n_stokes": cmb.n_stokes,
            }
            sky["need_radec"] = True

        map_frame_radec = None
        if input_map is not None:
            check_map_observable(input_map)
            n_frames = len(input_map.t)
            map_frame_radec = input_map.frame in ("ra/dec", "icrs")
            sky["need_radec"] = sky["need_radec"] or map_frame_radec
            sky["map"] = {
                "center": (float(input_map.center[0]), float(input_map.center[1])),
                "radec": map_frame_radec,
                "bilinear": map_kwargs.get("bilinear_sampling", True),
                "n_frames": n_frames,
            }
            if n_frames > 1:
                # time-evolving map: per-fine-sample frame index + blend
                # weight tracks (the same searchsorted/clip blend the
                # batch program bakes, sim/map.py static_map_samples),
                # streamed to the blocks alongside the pointing tracks
                t0 = float(obs.t[0])
                t_rel = np.asarray(obs.t, dtype=np.float64) - t0
                frame_t = np.asarray(input_map.t, dtype=np.float64) - t0
                fi = np.clip(np.searchsorted(frame_t, t_rel) - 1, 0, n_frames - 2)
                w_hi = np.clip(
                    (t_rel - frame_t[fi]) / (frame_t[fi + 1] - frame_t[fi]), 0.0, 1.0
                )
                self._map_fi_f = np.pad(fi.astype(np.int32), (0, pad_f), mode="edge")
                self._map_whi_f = np.pad(
                    w_hi.astype(np.float32), (0, pad_f), mode="edge"
                )

        for band, block in zip(obs.instrument.dets.bands, self.program.bands):
            entry = {"sw": jnp.asarray(stokes_weight[block.det_index])}
            if cmb is not None:
                pwv_side, el_side, P0, dPdT = cmb_power_tables(band, atm.spectrum, T_base)
                entry["cmb_P0_eval"] = make_table_eval(np.asarray(pwv_side), np.asarray(el_side), P0)
                entry["cmb_dPdT_eval"] = make_table_eval(np.asarray(pwv_side), np.asarray(el_side), dPdT)
            if input_map is not None:
                band_fwhm = compute_angular_fwhm(
                    fwhm_0=float(np.mean(obs.instrument.dets.primary_size)),
                    z=np.inf, nu=band.center,
                )
                channel_map = input_map.smooth(fwhm=Quantity(band_fwhm, "rad")).to(
                    "K_RJ", band=band
                )
                stages = []
                for channel, (nu_min, nu_max) in enumerate(input_map.nu_bin_bounds):
                    if band.nu.max() < float(nu_min.Hz) or float(nu_max.Hz) < band.nu.min():
                        continue
                    tab = map_transmission_table(band, input_map, channel, atm.spectrum, T_base)
                    stages.append({
                        "cal_eval": make_table_eval(
                            np.asarray(block.pwv_side), np.asarray(block.el_side), tab
                        ),
                        # (n_stokes, n_frames, ny, nx) — frame axis kept
                        # so time-evolving maps stream too
                        "fields": np.asarray(channel_map.data[:, channel], dtype=np.float32),
                        "x_side": np.asarray(channel_map.x_side),
                        "y_side": np.asarray(channel_map.y_side),
                    })
                entry["map_stages"] = stages
            sky["bands"].append(entry)

        if sky["need_radec"]:
            self._load_radec_tracks(obs, pad_f)
        self.sky = sky

    def _setup_blocked_binning(self):
        """Static geometry for in-scan blocked binning (ops/binning.py's
        hat contractions instead of scatter-adds).

        Detectors are Hilbert-ordered into focal-plane blocks once
        (pointing-independent); window ORIGINS are computed in-program
        per (det-block, time-chunk) from the actual pixel ids, but the
        window SIZE must be static, so it is bounded here empirically:
        per-block extreme detectors x a strided time subsample are run
        through the exact binning rotation, and the largest
        (block, chunk) span plus stride/rounding/rotation margins fixes
        (wy, wx). The in-scan `bin_lost` counter hard-verifies the
        bound — any in-map sample falling outside its window makes
        run() raise rather than silently bias the map. Returns None
        (scatter fallback) when even the smallest det-block/chunk
        candidate would need windows spanning most of the map.

        Computed LAZILY (via the `_bin_plan` property) so runs that
        never pick the blocked path — CPU autos, det-sharded runs —
        never pay the setup sweep."""
        from .binning import _hilbert_order
        from ..coords.transforms import offsets_to_phi_theta

        # candidate-invariant setup (hoisted out of the loop)
        o = np.asarray(self.program.offsets, dtype=np.float64)
        n_det = self.n_det
        qy = np.round((o[:, 1] - o[:, 1].min()) / self.res).astype(np.int64)
        qx = np.round((o[:, 0] - o[:, 0].min()) / self.res).astype(np.int64)
        order = _hilbert_order(qy, qx)
        if self.frame == "ra/dec":
            phi_f, theta_f, q_f = self.bs_ra_f, self.bs_dec_f, self.q_f
        else:
            phi_f, theta_f, q_f = self.bs_az_f, self.bs_el_f, None
        # max boresight pixel step per sample, for the stride margin
        offs_b = np.asarray(
            phi_theta_to_offsets_jit(
                jnp.asarray(np.stack([phi_f, theta_f], -1)), self.center[0], self.center[1]
            )
        ) / self.res
        step_cells = float(np.abs(np.diff(offs_b, axis=0)).max())
        inv = (o, order, phi_f, theta_f, q_f, step_cells)

        # wide focal planes / fast scans need smaller blocks or chunks
        # to keep the window below half the map; 1024-det blocks first —
        # the batch binner's granularity (fewer, larger tiles)
        for det_block, chunk in ((1024, 64), (512, 64), (512, 32), (256, 32),
                                 (128, 16), (64, 16)):
            plan = self._try_blocked_binning(inv, det_block, chunk)
            if plan is not None:
                self._run_params = self._bound_runs(inv, plan)
                return plan
        return None

    def _bound_runs(self, inv, plan):
        """Static run-slot bound for the in-scan run-compressed binner
        (ops/binning_runs.bin_runs_traced): exact pixel-run counts per
        extraction segment for the per-block EXTREME detectors over the
        FULL padded timeline (cheap: 8 dets/block), times a 1.25x margin
        for the between-direction speed underread (the cos 22.5 deg
        argument of the window bound) plus alignment slack. The runtime
        `lost` counter hard-verifies the bound exactly like the window
        bound. Returns {"seg", "r_max"} or None (no compression to be
        had -> per-sample blocked path)."""
        import os

        if os.environ.get("MARIA_TPU_STREAM_RUNS", "").lower() in ("0", "off"):
            return None
        o, order, phi_f, theta_f, q_f, step_cells = inv
        seg = min(64, plan.chunk)
        if plan.chunk % seg:
            return None
        det_block, n_db = plan.det_block, plan.n_blocks
        order_p = plan.order
        ob = o[order_p].reshape(n_db, det_block, 2)
        ex_scores = np.stack(
            [ob[..., 0], -ob[..., 0], ob[..., 1], -ob[..., 1],
             ob[..., 0] + ob[..., 1], ob[..., 0] - ob[..., 1],
             -ob[..., 0] + ob[..., 1], -ob[..., 0] - ob[..., 1]], axis=-1,
        )
        ex_idx = ex_scores.argmax(axis=1)
        eo = np.take_along_axis(ob, ex_idx[:, :, None], axis=1).reshape(-1, 2)

        n_chunks_b = -(-self.B // plan.chunk)
        n_pad_t = self.n_blocks * n_chunks_b * plan.chunk

        def pad_time(a):
            blocks = a.reshape(self.n_blocks, self.B)
            pad_t = n_chunks_b * plan.chunk - self.B
            if pad_t:
                blocks = np.pad(blocks, ((0, 0), (0, pad_t)), mode="edge")
            return blocks.reshape(-1)

        phi_s, theta_s = pad_time(phi_f), pad_time(theta_f)
        if q_f is not None:
            q_s = pad_time(q_f)
            cq, sq = np.cos(q_s), np.sin(q_s)
            det = np.stack(
                [eo[:, :1] * cq - eo[:, 1:] * sq, eo[:, :1] * sq + eo[:, 1:] * cq],
                axis=-1,
            )
        else:
            det = np.broadcast_to(eo[:, None, :], (eo.shape[0], n_pad_t, 2))
        try:
            host = jax.devices("cpu")[0]
        except RuntimeError:
            host = None
        with jax.default_device(host):  # host-side setup math, read back at once
            pt = np.asarray(
                offsets_to_phi_theta(
                    jnp.asarray(det, jnp.float32), jnp.asarray(phi_s), jnp.asarray(theta_s)
                )
            )
            offs = np.asarray(
                phi_theta_to_offsets_jit(jnp.asarray(pt), self.center[0], self.center[1])
            )
        x0 = -(self.n_x - 1) / 2 * self.res
        y0 = -(self.n_y - 1) / 2 * self.res
        ix = np.round((offs[..., 0] - x0) / self.res).astype(np.int64)
        iy = np.round((offs[..., 1] - y0) / self.res).astype(np.int64)
        inside = (ix >= 0) & (ix < self.n_x) & (iy >= 0) & (iy < self.n_y)
        pix = np.where(inside, iy * self.n_x + ix, -1)
        p_s = pix.reshape(len(eo), n_pad_t // seg, seg)
        runs = 1 + (p_s[..., 1:] != p_s[..., :-1]).sum(axis=-1)
        r_max = int(-(-(int(np.ceil(1.25 * runs.max())) + 2) // 8) * 8)
        if r_max > 0.75 * seg:
            return None  # scan too fast per segment — no compression
        return {"seg": seg, "r_max": r_max}

    def _try_blocked_binning(self, inv, det_block: int, chunk: int):
        from .binning import BlockedBinPlan
        from ..coords.transforms import offsets_to_phi_theta

        o, order, phi_f, theta_f, q_f, step_cells = inv
        n_det = self.n_det
        det_block = min(det_block, -(-n_det // 8) * 8)
        n_db = -(-n_det // det_block)
        pad_d = n_db * det_block - n_det
        order_p = (
            np.concatenate([order, np.full(pad_d, order[-1], dtype=order.dtype)])
            if pad_d else order
        )

        # <=8 extreme detectors per block bound the block's footprint
        # at the 8 sampled rotation directions; the worst case BETWEEN
        # directions is covered by the rotation margin below
        ob = o[order_p].reshape(n_db, det_block, 2)
        ex_scores = np.stack(
            [ob[..., 0], -ob[..., 0], ob[..., 1], -ob[..., 1],
             ob[..., 0] + ob[..., 1], ob[..., 0] - ob[..., 1],
             -ob[..., 0] + ob[..., 1], -ob[..., 0] - ob[..., 1]], axis=-1,
        )
        ex_idx = ex_scores.argmax(axis=1)  # (n_db, 8) indices into each block
        ex_offs = np.take_along_axis(ob, ex_idx[:, :, None], axis=1)  # (n_db, 8, 2)

        # exact binning rotation on a strided time subsample
        stride = 4
        n_chunks_b = -(-self.B // chunk)
        n_pad_t = self.n_blocks * n_chunks_b * chunk

        def pad_time(a):
            # chunks live inside padded blocks: replicate each block's
            # last sample so padded chunk tails don't widen the span
            blocks = a.reshape(self.n_blocks, self.B)
            pad_t = n_chunks_b * chunk - self.B
            if pad_t:
                blocks = np.pad(blocks, ((0, 0), (0, pad_t)), mode="edge")
            return blocks.reshape(-1)

        sub = slice(0, n_pad_t, stride)
        phi_s, theta_s = pad_time(phi_f)[sub], pad_time(theta_f)[sub]
        eo = ex_offs.reshape(-1, 2)  # (n_db * 8, 2)
        if q_f is not None:
            q_s = pad_time(q_f)[sub]
            cq, sq = np.cos(q_s), np.sin(q_s)
            det = np.stack(
                [eo[:, :1] * cq - eo[:, 1:] * sq, eo[:, :1] * sq + eo[:, 1:] * cq], axis=-1
            )
        else:
            det = np.broadcast_to(eo[:, None, :], (eo.shape[0], len(phi_s), 2))
        pt = np.asarray(offsets_to_phi_theta(jnp.asarray(det), jnp.asarray(phi_s), jnp.asarray(theta_s)))
        offs = np.asarray(phi_theta_to_offsets_jit(jnp.asarray(pt), self.center[0], self.center[1]))
        x0 = -(self.n_x - 1) / 2 * self.res
        y0 = -(self.n_y - 1) / 2 * self.res
        # clip to the map: samples outside never need window coverage
        ix = np.clip(np.round((offs[..., 0] - x0) / self.res), 0, self.n_x - 1)
        iy = np.clip(np.round((offs[..., 1] - y0) / self.res), 0, self.n_y - 1)

        n_sub_chunk = chunk // stride
        def span(a):
            c = a.reshape(n_db, 8, -1, n_sub_chunk)
            per = c.max(axis=(1, 3)) - c.min(axis=(1, 3))  # (n_db, n_chunks_total)
            return per.max()

        # margins: (a) what the time stride can miss — pointing moves at
        # most step_cells per sample; (b) under field rotation, the 8
        # extremes sampled at 45-degree directions under-read a circular
        # block's span by up to (1 - cos(22.5 deg)) ~ 7.6% of its radius
        # per side; (c) rounding slack
        m = int(np.ceil(step_cells * stride)) + 4
        if q_f is not None:
            rad_cells = float(
                np.sqrt(((ob - ob.mean(axis=1, keepdims=True)) ** 2).sum(-1)).max()
            ) / self.res
            m += int(np.ceil(0.08 * rad_cells)) + 1
        wy = int(-(-(span(iy) + 1 + 2 * m) // 8) * 8)
        wx = int(-(-(span(ix) + 1 + 2 * m) // 8) * 8)
        if wy > self.n_y or wx > self.n_x or wy * wx > 0.5 * self.n_y * self.n_x:
            return None
        return BlockedBinPlan(
            n_y=self.n_y, n_x=self.n_x, wy=wy, wx=wx, chunk=chunk,
            n_chunks=n_chunks_b, det_block=det_block, n_blocks=n_db, n_t=self.B,
            order=order_p.astype(np.int32), ly=None, lx=None, origins=None,
        )

    def _setup_resident_plans(self):
        """Device-RESIDENT per-streaming-block run plans — the streamed
        binner with the BATCH binner's static plans.

        The in-scan formulations (per-sample blocked, fused run
        extraction) derive their geometry every block, while the batch
        run-compressed binner reads a static precomputed plan. Pointing
        is static, so
        the streamed path can have one too WITHOUT materializing
        full-TOD id arrays: per-block ids are recomputed on device at
        setup and compressed to int8 run plans (3 B/run-slot ~ 1.5
        B/sample vs 8 B/sample of raw ids), built through ONE compiled
        stats pass + ONE compiled extraction pass shared by all blocks
        (uniform window/r_max = maxima over blocks).

        Residency is budgeted (3/8 of the device's memory, 6 GB on the
        CPU; override MARIA_TPU_STREAM_PLAN_GB): past the budget the
        executor falls back to the bounded-memory in-scan path, keeping
        the arbitrarily-long contract. Returns the plan dict or None."""
        import os

        if os.environ.get("MARIA_TPU_STREAM_RESIDENT", "").lower() in ("0", "off"):
            return None
        bp = self._bin_plan
        if bp is None:
            return None
        from .binning_runs import (
            RunChunkBinPlan,
            make_sibling_run_extract,
            make_sibling_run_stats,
        )

        nb, db, chunk, nc = bp.n_blocks, bp.det_block, bp.chunk, bp.n_chunks
        seg = min(64, chunk)
        if chunk % seg:
            return None
        n_seg = chunk // seg
        order_dev = jnp.asarray(bp.order)
        pixel_fn = self._make_pixel_fn()
        pix_jit = jax.jit(
            lambda b, az, el, sky: pixel_fn(b, az, el, sky)
        )

        def block_ids(xs):
            b, az_b, el_b = xs[0][0], xs[1][0], xs[2][0]
            sky_b = tuple(t[0] for t in xs[3]) if len(xs) == 4 else None
            iy, ix, inside = pix_jit(b, az_b, el_b, sky_b)
            return jnp.where(inside, iy, -1), jnp.where(inside, ix, -1)

        statics = dict(n_det=self.n_det, det_block=db, n_blocks=nb,
                       n_chunks=nc, chunk=chunk, seg=seg, n_x=self.n_x)
        stats_fn = make_sibling_run_stats(order_dev, **statics)
        all_stats = []
        for _, _, xs in self._xs_groups(0, 1):
            iym, ixm = block_ids(xs)
            all_stats.append([np.asarray(v) for v in stats_fn(iym, ixm)])
        oy = np.stack([s[0] for s in all_stats])  # (n_sb, nb, nc)
        hy = np.stack([s[1] for s in all_stats])
        ox = np.stack([s[2] for s in all_stats])
        hx = np.stack([s[3] for s in all_stats])
        wy = int(-(-int((hy - oy + 1).max()) // 8) * 8)
        wx = int(-(-int((hx - ox + 1).max()) // 8) * 8)
        r_max = int(-(-int(max(int(s[4]) for s in all_stats)) // 8) * 8)
        if (wy * wx > 0.5 * self.n_y * self.n_x or wy > self.n_y or wx > self.n_x
                or r_max > 0.75 * seg):
            return None

        n_sb = len(all_stats)
        from ..backend import memory_budget

        budget = (float(os.environ["MARIA_TPU_STREAM_PLAN_GB"]) * 1e9
                  if os.environ.get("MARIA_TPU_STREAM_PLAN_GB")
                  else memory_budget(3 / 8, 6e9))
        idx_bytes = 1 if (seg <= 128 and max(wy, wx) < 127) else 4
        plan_bytes = n_sb * nb * nc * (
            3 * db * n_seg * r_max * idx_bytes + 4 * wy * wx
        )
        if plan_bytes > budget:
            logger.info(
                "resident bin plans would need %.1f GB (> %.1f budget); "
                "falling back to in-scan binning", plan_bytes / 1e9, budget / 1e9,
            )
            return None

        oy = np.clip(oy, 0, self.n_y - wy)
        ox = np.clip(ox, 0, self.n_x - wx)
        extract_fn = make_sibling_run_extract(
            order_dev, n_det=self.n_det, det_block=db, n_blocks=nb, n_chunks=nc,
            chunk=chunk, seg=seg, r_max=r_max, wy=wy, wx=wx,
            n_y=self.n_y, n_x=self.n_x,
        )
        Es, LYs, LXs, WCs = [], [], [], []
        for sb, (_, _, xs) in enumerate(self._xs_groups(0, 1)):
            iym, ixm = block_ids(xs)
            e, r_ly, r_lx, wcnt, _ = extract_fn(
                iym, ixm, jnp.asarray(oy[sb]), jnp.asarray(ox[sb])
            )
            Es.append(e)
            LYs.append(r_ly)
            LXs.append(r_lx)
            WCs.append(wcnt)
        template = RunChunkBinPlan(
            n_y=self.n_y, n_x=self.n_x, wy=wy, wx=wx, chunk=chunk, n_chunks=nc,
            det_block=db, n_blocks=nb, n_det=self.n_det, n_t=self.B, seg=seg,
            r_max=r_max, order=bp.order, e_idx=None, run_ly=None, run_lx=None,
            origins=None, wcnt=None, hits=None,
        )
        logger.info(
            "resident bin plans: %d blocks x (%d, %d, %d, %d, %d), window %dx%d, "
            "%.2f GB", n_sb, nb, db, nc, n_seg, r_max, wy, wx, plan_bytes / 1e9,
        )
        return {
            "E": jnp.stack(Es), "LY": jnp.stack(LYs), "LX": jnp.stack(LXs),
            "WCNT": jnp.stack(WCs),
            "ORG": jnp.asarray(np.stack([oy, ox], axis=-1), jnp.int32),
            "template": template, "order_dev": order_dev, "n_sb": n_sb,
        }

    @property
    def _resident(self):
        """Lazy resident-plan build; run() resolves it only when the
        blocked path is taken on-device."""
        if self._resident_cache == "unset":
            self._resident_cache = self._setup_resident_plans()
        return self._resident_cache

    def _load_radec_tracks(self, obs, pad_f: int):
        if self.bs_ra_f is not None:
            return
        self.bs_ra_f = np.pad(
            np.asarray(obs.boresight.ra, dtype=np.float32), (0, pad_f), mode="edge"
        )
        self.bs_dec_f = np.pad(
            np.asarray(obs.boresight.dec, dtype=np.float32), (0, pad_f), mode="edge"
        )
        self.q_f = np.pad(np.asarray(obs.q, dtype=np.float32), (0, pad_f), mode="edge")

    # ------------------------------------------------------------------
    def init_state(self, key):
        """(coarse fields, per-band noise states, gains) for one realization."""
        p = self.program
        tables = p.device_tables()
        if self._coarse_jit is None:
            # cached: a fresh jit wrapper per call would re-trace and
            # re-compile the heaviest stage (screens + AR + LOS) on every
            # run()/tod_blocks()
            self._coarse_jit = jax.jit(
                lambda k, o, a, e, tb: p._loadings(k, o, a, e, upto="coarse", tables=tb)
            )
        coarse = self._coarse_jit(*p.example_args(key), tables)
        # gains: same stream as the batch program (total_power_fn)
        gains = p.draw_gains(key)
        if not hasattr(gains, "shape"):
            gains = jnp.ones((self.n_det, 1), dtype=jnp.float32)
        key_noise = jax.random.split(key, 3)[1]
        noise_states, noise_keys = [], []
        for i, (band, model) in enumerate(zip(p.bands, self.noise_models)):
            band_key = jax.random.fold_in(key_noise, i)
            key_init, key_stream = jax.random.split(band_key)
            noise_states.append(model.init_state(key_init, len(band.det_index)))
            noise_keys.append(key_stream)
        # coarse loading padded once for the haloed blockwise upsample
        lc = coarse["loading_c"]
        lc_pad = pad_coarse_for_blocks(lc, self.block_tc, self.n_blocks)
        sky_state = {}
        if self.sky is not None:
            # coarse pwv/el drive the per-block calibration factors; the
            # ext pads carry the one-cell halo the integration kernel needs
            sky_state = {
                "pwv_pad2": pad_coarse_for_blocks_ext(coarse["pwv_c"], self.block_tc, self.n_blocks),
                "pwv_last": coarse["pwv_c"][:, -1],
                "el_pad2": pad_coarse_for_blocks_ext(coarse["el_c"], self.block_tc, self.n_blocks),
                "el_last": coarse["el_c"][:, -1],
                "cmb_fields": (
                    jnp.asarray(self.sky["cmb"]["fields"]) if self.sky["cmb"] else ()
                ),
                "map_fields": [
                    [jnp.asarray(st["fields"]) for st in e.get("map_stages", [])]
                    for e in self.sky["bands"]
                ],
            }
        return {
            **sky_state,
            "lc_pad": lc_pad,
            "lc_last": lc[:, -1],
            "gains": gains,
            "noise": noise_states,
            "noise_keys": noise_keys,
            "map_sum": jnp.zeros((self.n_y * self.n_x,), dtype=jnp.float32),
            "map_wgt": jnp.zeros((self.n_y * self.n_x,), dtype=jnp.float32),
            # Welch accumulators (only updated when run(accumulate_psd=True))
            "psd_sum": [
                jnp.zeros((self.B // 2 + 1,), dtype=jnp.float32) for _ in p.bands
            ],
            "psd_blocks": jnp.float32(0.0),
            # valid samples dropped by the static MXU-binning window
            # (must stay 0; run() raises otherwise)
            "bin_lost": jnp.float32(0.0),
        }

    # ------------------------------------------------------------------
    def _make_pixel_fn(self):
        """Traceable per-block pixel ids — the single source of the
        streamed binning-pixel convention (round, centered grid; same as
        BinMapper), shared by the in-scan binner AND the streamed ML
        mapper's pointing operators.

        Returns pixel_ids(b, bs_az_b, bs_el_b, xs_sky) ->
        (iy (n_det, B) int32, ix, inside bool) where `inside` already
        excludes out-of-map, beyond-n_t phantom, and padded detector
        samples."""
        p = self.program
        r, B = self.r, self.B
        n_t, n_det = self.n_t, self.n_det
        n_x, n_y, res = self.n_x, self.n_y, self.res
        c_az, c_el = self.center
        offsets = jnp.asarray(p.offsets, dtype=jnp.float32)
        interior = slice(r, r + B)
        n_real = self.n_real_det
        real_row = (np.arange(n_det) < n_real)[:, None]

        def pixel_ids(b, bs_az_b, bs_el_b, xs_sky):
            if self.frame == "ra/dec":
                ra_ext, dec_ext, q_ext = xs_sky[0], xs_sky[1], xs_sky[2]
                cq, sq = jnp.cos(q_ext[interior]), jnp.sin(q_ext[interior])
                offs_rot = jnp.stack(
                    [offsets[:, :1] * cq - offsets[:, 1:] * sq,
                     offsets[:, :1] * sq + offsets[:, 1:] * cq], axis=-1)
                pt = offsets_to_phi_theta(offs_rot, ra_ext[interior], dec_ext[interior])
            else:
                pt = offsets_to_phi_theta(offsets[:, None, :], bs_az_b, bs_el_b)
            offs = phi_theta_to_offsets_jit(pt, c_az, c_el)
            x0 = -(n_x - 1) / 2 * res
            y0 = -(n_y - 1) / 2 * res
            ix = jnp.round((offs[..., 0] - x0) / res).astype(jnp.int32)
            iy = jnp.round((offs[..., 1] - y0) / res).astype(jnp.int32)
            g = b * self.block_tc * r + jnp.arange(B)
            inside = (
                (ix >= 0) & (ix < n_x) & (iy >= 0) & (iy < n_y)
                & (g < n_t)[None, :] & jnp.asarray(real_row)
            )
            return iy, ix, inside

        return pixel_ids

    def _make_block_fn(
        self, with_tod: bool, with_psd: bool = False, use_blocked: bool = False,
        with_map: bool = True,
    ):
        import os

        # with_map=False skips the map accumulation: the streamed ML
        # mapper's synthesis passes consume the TOD blocks directly and
        # accumulate their own products. The env toggle serves the same
        # purpose for the stage profiler (trace-time read — set it
        # before the executor's first run in a fresh process).
        skip_bin = (not with_map) or os.environ.get("MARIA_TPU_STREAM_SKIP_BIN") == "1"
        p = self.program
        r, B, block_tc = self.r, self.B, self.block_tc
        n_c, n_t, n_det = self.n_c, self.n_t, self.n_det
        n_x, n_y, res = self.n_x, self.n_y, self.res
        c_az, c_el = self.center
        offsets = jnp.asarray(p.offsets, dtype=jnp.float32)

        sky = self.sky
        mueller_I = jnp.asarray(p.mueller_I, dtype=jnp.float32)
        interior = slice(r, r + B)
        # pad_detectors replicates the last detector to fill det shards;
        # those rows must not reach the map or the PSDs (program.py
        # pad_detectors contract)
        n_real = self.n_real_det
        real_row = (np.arange(n_det) < n_real)[:, None]
        band_real = [
            jnp.asarray((np.asarray(band.det_index) < n_real), dtype=jnp.float32)
            for band in p.bands
        ]

        def sky_fields_block(state, xs_sky, c0):
            """Non-atmosphere sky loading for this block (pW, ungained):
            the same physics as the batch program's cmb/map stages, with
            the static timelines evaluated here instead of baked."""
            from ..ops.interp import interp_bilinear_grid

            total = jnp.zeros((n_det, B), dtype=jnp.float32)
            # ext fine grids: the integration kernel needs a one-cell halo
            pwv_ext = upsample_block_ext(
                state["pwv_pad2"], c0, block_tc, r, n_c, state["pwv_last"], kind="linear"
            )
            el_ext = upsample_block_ext(
                state["el_pad2"], c0, block_tc, r, n_c, state["el_last"], kind="cubic"
            )
            ra_ext, dec_ext, q_ext, az_ext, el_tr_ext, *frame_tracks = xs_sky

            if sky["cmb"] is not None:
                cm = sky["cmb"]
                cq, sq = jnp.cos(q_ext[interior]), jnp.sin(q_ext[interior])
                cmb_piece = {}
                for i, (band, entry) in enumerate(zip(p.bands, sky["bands"])):
                    o = offsets[band.det_sel]
                    offs_rot = jnp.stack(
                        [o[:, :1] * cq - o[:, 1:] * sq, o[:, :1] * sq + o[:, 1:] * cq],
                        axis=-1,
                    )
                    pt = offsets_to_phi_theta(offs_rot, ra_ext[interior], dec_ext[interior])
                    ra_d, dec_d = pt[..., 0], pt[..., 1]
                    if cm["frame"] == "galactic":
                        from ..coords import ephemeris as eph
                        from ..healpix.core import ang2pix_ring

                        R = jnp.asarray(eph.ICRS_TO_GAL, dtype=jnp.float32)
                        cos_d = jnp.cos(dec_d)
                        v = jnp.stack(
                            [jnp.cos(ra_d) * cos_d, jnp.sin(ra_d) * cos_d, jnp.sin(dec_d)],
                            axis=-1,
                        )
                        vg = jnp.einsum("ij,...j->...i", R, v)
                        phi = jnp.arctan2(vg[..., 1], vg[..., 0])
                        lat = jnp.arcsin(jnp.clip(vg[..., 2], -1, 1))
                    else:
                        from ..healpix.core import ang2pix_ring

                        phi, lat = ra_d, dec_d
                    pix = ang2pix_ring(cm["nside"], jnp.pi / 2 - lat, phi)
                    sample = 0.0
                    sw = entry["sw"]
                    for s in range(cm["n_stokes"]):
                        sample = sample + sw[:, s][:, None] * jnp.take(
                            state["cmb_fields"][s], pix, axis=0
                        )
                    pwv_b = pwv_ext[band.det_sel][:, interior]
                    el_b = el_ext[band.det_sel][:, interior]
                    P0 = entry["cmb_P0_eval"](pwv_b, el_b)
                    dPdT = entry["cmb_dPdT_eval"](pwv_b, el_b)
                    cmb_piece[i] = (
                        P0.astype(jnp.float32) * mueller_I[band.det_sel, None]
                        + dPdT.astype(jnp.float32) * sample
                    )
                total = total + p._per_band_assemble(cmb_piece, (n_det, B))

            if sky["map"] is not None:
                mp = sky["map"]
                map_piece = {}
                for i, (band, entry) in enumerate(zip(p.bands, sky["bands"])):
                    if mp["radec"]:
                        cq, sq = jnp.cos(q_ext), jnp.sin(q_ext)
                        o = offsets[band.det_sel]
                        offs_rot = jnp.stack(
                            [o[:, :1] * cq - o[:, 1:] * sq, o[:, :1] * sq + o[:, 1:] * cq],
                            axis=-1,
                        )
                        pt = offsets_to_phi_theta(offs_rot, ra_ext, dec_ext)
                    else:
                        pt = offsets_to_phi_theta(
                            offsets[band.det_sel][:, None, :], az_ext, el_tr_ext
                        )
                    d = phi_theta_to_offsets_jit(pt, mp["center"][0], mp["center"][1])
                    pwv_b = pwv_ext[band.det_sel]
                    el_b = el_ext[band.det_sel]
                    piece_ext = jnp.zeros((d.shape[0], B + 2 * r), dtype=jnp.float32)
                    sw = entry["sw"]
                    n_frames = mp["n_frames"]
                    if n_frames > 1:
                        fi_ext, whi_ext = frame_tracks
                        # per-frame blend weights over the ext grid — the
                        # batch program's exact searchsorted blend
                        # (sim/map.py static_map_samples)
                        frame_w = [
                            jnp.where(fi_ext == f, 1.0 - whi_ext, 0.0)
                            + jnp.where(fi_ext + 1 == f, whi_ext, 0.0)
                            for f in range(n_frames)
                        ]
                    for j, st_ in enumerate(entry["map_stages"]):
                        fields = state["map_fields"][i][j]
                        sample = 0.0
                        for s in range(fields.shape[0]):
                            # axes stay host-side numpy: the interp
                            # classifies them statically (tiny constants)
                            dx, dy = d[..., 0], d[..., 1]

                            def sample_frame(img):
                                if mp["bilinear"]:
                                    return interp_bilinear_grid(
                                        img, dx, dy, st_["x_side"], st_["y_side"]
                                    )
                                # nearest-pixel, matching
                                # ProjectionMap.sample(bilinear=False)
                                xs, ys = st_["x_side"], st_["y_side"]
                                xr, yr = float(xs[1] - xs[0]), float(ys[1] - ys[0])
                                ix = jnp.clip(jnp.round((dx - xs[0]) / xr).astype(jnp.int32), 0, len(xs) - 1)
                                iy = jnp.clip(jnp.round((dy - ys[0]) / yr).astype(jnp.int32), 0, len(ys) - 1)
                                inside = (
                                    (dx >= xs[0] - xr / 2) & (dx <= xs[-1] + xr / 2)
                                    & (dy >= ys[0] - yr / 2) & (dy <= ys[-1] + yr / 2)
                                )
                                return jnp.where(inside, img[iy, ix], 0.0)

                            if n_frames == 1:
                                vals = sample_frame(fields[s, 0])
                            else:
                                vals = 0.0
                                for f in range(n_frames):
                                    vals = vals + frame_w[f][None, :] * sample_frame(
                                        fields[s, f]
                                    )
                            sample = sample + sw[:, s][:, None] * vals
                        cal = st_["cal_eval"](pwv_b, el_b)
                        piece_ext = piece_ext + cal.astype(jnp.float32) * sample
                    # continuous-integration kernel on the halo'd product,
                    # clamped at the global fine edges like the batch pad
                    g0 = (c0 - 1) * r
                    g = g0 + jnp.arange(B + 2 * r)
                    idx = jnp.clip(g, 0, n_t - 1) - g0
                    clamped = jnp.take_along_axis(
                        piece_ext, jnp.broadcast_to(idx, piece_ext.shape), axis=-1
                    )
                    x = clamped[:, r - 1 : r + B + 1]
                    map_piece[i] = 0.25 * x[:, :-2] + 0.5 * x[:, 1:-1] + 0.25 * x[:, 2:]
                total = total + p._per_band_assemble(map_piece, (n_det, B))
            return total

        need_tracks = sky is not None or self.frame == "ra/dec"
        if use_blocked:
            # resolve the lazy plan EAGERLY: first-touching it inside the
            # traced scan body would run the setup sweep under tracing
            bin_plan = self._bin_plan
            bin_order_dev = jnp.asarray(bin_plan.order)
        use_resident = use_blocked and self._resident is not None
        if use_resident:
            res_template = self._resident["template"]
            res_order_dev = self._resident["order_dev"]
            res_n_sb = self._resident["n_sb"]
            # "shifted" matches the batch binner's accumulation (~1e-4
            # relative class, one pass instead of hilo's two); set
            # MARIA_TPU_STREAM_BIN_PRECISION=hilo for ~2^-16
            res_precision = os.environ.get(
                "MARIA_TPU_STREAM_BIN_PRECISION", "shifted")
        pixel_ids = self._make_pixel_fn()

        def block_fn(state, xs, plans=None):
            if need_tracks:
                b, bs_az_b, bs_el_b, xs_sky = xs
            else:
                b, bs_az_b, bs_el_b = xs
                xs_sky = None
            c0 = b * block_tc

            atm = upsample_block_phases(
                state["lc_pad"], c0, block_tc, r, n_c, state["lc_last"], kind="cubic"
            )
            fields_sum = atm  # ungained non-noise loading (pW)
            if sky is not None:
                fields_sum = fields_sum + sky_fields_block(state, xs_sky, c0)
            tod = fields_sum * state["gains"]

            # streaming noise per band (NEP_per_loading sees this block's
            # UNGAINED non-noise loading, mirroring the batch program's
            # field/gain operation order in total_power_fn)
            if p.with_noise:
                noise_pieces, new_states = {}, []
                for i, (band, model) in enumerate(zip(p.bands, self.noise_models)):
                    key_b = jax.random.fold_in(state["noise_keys"][i], b)
                    st, unscaled = model.block(
                        state["noise"][i], key_b, len(band.det_index), B
                    )
                    new_states.append(st)
                    if band.NEP_per_loading:
                        total_NEP = band.NEP + band.NEP_per_loading * 1e-12 * fields_sum[band.det_sel]
                    else:
                        total_NEP = band.NEP
                    noise_pieces[i] = 1e12 * total_NEP * unscaled
                tod = tod + p._per_band_assemble(noise_pieces, (n_det, B))
            else:
                new_states = state["noise"]

            # bin the block straight into the carried map (pW sums);
            # same pixel convention as BinMapper (round, centered grid)
            if skip_bin:
                return dict(state, noise=new_states), (tod if with_tod else ())
            if use_resident:
                # HBM-resident static run plan for this block — the
                # batch binner's fast path, streamed (_setup_resident
                # _plans). Phantom tail blocks (b >= n_sb) reuse the
                # last block's plan but their contribution is zeroed.
                from .binning_runs import bin_runchunk

                bi = jnp.clip(b, 0, res_n_sb - 1)
                take1 = lambda a: jax.lax.dynamic_index_in_dim(  # noqa: E731
                    a, bi, axis=0, keepdims=False)
                e_b, ly_b, lx_b = take1(plans["E"]), take1(plans["LY"]), take1(plans["LX"])
                wcnt_b, org_b = take1(plans["WCNT"]), take1(plans["ORG"])
                maps = bin_runchunk(
                    tod, res_template, e_idx=e_b, run_ly=ly_b, run_lx=lx_b,
                    origins=org_b, order=res_order_dev, wcnt=wcnt_b,
                    precision=res_precision,
                )
                # key-independent hit counts: place the plan's count
                # windows (per-block so checkpoint/resume stays exact)
                tp = res_template
                full_w = jnp.pad(
                    wcnt_b.reshape(-1, tp.wy, tp.wx),
                    ((0, 0), (0, n_y - tp.wy), (0, n_x - tp.wx)),
                )
                placed = jax.vmap(
                    lambda w, o: jnp.roll(w, shift=(o[0], o[1]), axis=(-2, -1))
                )(full_w, org_b.reshape(-1, 2))
                live = (b < res_n_sb).astype(jnp.float32)
                map_sum = state["map_sum"] + live * maps.reshape(-1)
                map_wgt = state["map_wgt"] + live * placed.sum(axis=0).reshape(-1)
                bin_lost = state["bin_lost"]  # plan windows fit by construction
            elif use_blocked:
                iy, ix, inside = pixel_ids(b, bs_az_b, bs_el_b, xs_sky)
                # MXU windowed binning (no scatters): block the det axis
                # by the static Hilbert order, compute window origins
                # from this block's actual ids, and contract one-hot
                # hats (bin_blocked). data channel-stacks (tod, ones) so
                # sums and hit counts share the hats. `lost` counts any
                # valid sample the static window would silently drop —
                # run() raises on a nonzero total.
                from .binning import bin_blocked, blocked_local_ids

                bp, order_dev = bin_plan, bin_order_dev
                ly, lx, origins, lost = blocked_local_ids(
                    jnp.where(inside, iy, -1), jnp.where(inside, ix, -1),
                    order_dev, n_det, bp.det_block, bp.n_blocks,
                    bp.n_chunks, bp.chunk, bp.wy, bp.wx, n_y, n_x,
                )
                off_dtype = jnp.int8 if max(bp.wy, bp.wx) < 127 else jnp.int32

                data2 = jnp.stack([tod, jnp.ones_like(tod)])
                maps = bin_blocked(
                    data2, bp,
                    ly=ly.astype(off_dtype), lx=lx.astype(off_dtype),
                    origins=origins, order=order_dev,
                )
                map_sum = state["map_sum"] + maps[0].reshape(-1)
                map_wgt = state["map_wgt"] + maps[1].reshape(-1)
                bin_lost = state["bin_lost"] + lost.sum().astype(jnp.float32)
            else:
                iy, ix, inside = pixel_ids(b, bs_az_b, bs_el_b, xs_sky)
                pix = jnp.where(inside, iy * n_x + ix, n_y * n_x)  # overflow bucket
                w = inside.astype(jnp.float32)
                map_sum = state["map_sum"] + bin_scatter(tod * w, pix, n_y * n_x + 1)[:-1]
                map_wgt = state["map_wgt"] + bin_scatter(w, pix, n_y * n_x + 1)[:-1]
                bin_lost = state["bin_lost"]

            new_state = dict(
                state, noise=new_states, map_sum=map_sum, map_wgt=map_wgt, bin_lost=bin_lost
            )

            if with_psd:
                # Welch: detrended + Hann-windowed per-band periodograms,
                # mean over REAL band detectors; partial tail blocks
                # excluded (their padded samples would bias the spectrum)
                full = ((b + 1) * B <= n_t).astype(jnp.float32)
                hann = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * jnp.arange(B) / B)
                # one-sided scale: interior bins double, DC/Nyquist do not
                # (the scipy.signal.welch convention)
                one_sided = jnp.full(B // 2 + 1, 2.0).at[0].set(1.0)
                if B % 2 == 0:
                    one_sided = one_sided.at[-1].set(1.0)
                norm = one_sided / (p.sample_rate * jnp.sum(hann**2))
                psd_sum = []
                for i, band in enumerate(p.bands):
                    x = tod[band.det_sel]
                    x = x - x.mean(axis=-1, keepdims=True)
                    spec = jnp.abs(jnp.fft.rfft(x * hann, axis=-1)) ** 2
                    w_real = band_real[i]
                    mean_spec = (w_real[:, None] * spec).sum(axis=0) / jnp.maximum(
                        w_real.sum(), 1.0
                    )
                    psd_sum.append(state["psd_sum"][i] + full * norm * mean_spec)
                new_state["psd_sum"] = psd_sum
                new_state["psd_blocks"] = state["psd_blocks"] + full
            return new_state, (tod if with_tod else ())

        return block_fn

    def _group_fn(self, with_tod: bool, with_psd: bool = False, use_blocked: bool = False):
        # ONE jit per mode; jit re-specializes per group length. The
        # resident plan arrays ride as explicit jit ARGUMENTS (closure
        # constants of that size blow the remote compile request).
        resident = use_blocked and self._resident is not None
        key = (with_tod, with_psd, use_blocked, resident)
        if key not in self._block_fn_cache:
            block_fn = self._make_block_fn(with_tod, with_psd, use_blocked)

            @jax.jit
            def run_group(state, xs, plans):
                def body(s, x):
                    return block_fn(s, x, plans)

                return jax.lax.scan(body, state, xs)

            self._block_fn_cache[key] = run_group
        return self._block_fn_cache[key]

    def _plan_args(self, use_blocked: bool):
        """The resident plan arrays for run_group's third argument (an
        empty dict when the mode doesn't use them)."""
        if use_blocked and self._resident is not None:
            r = self._resident
            return {k: r[k] for k in ("E", "LY", "LX", "WCNT", "ORG")}
        return {}

    def _shard_state(self, state, mesh):
        """Lay the carried state out over the mesh's det axis: every
        detector-major leaf shards P("det", ...); map accumulators and
        scalars replicate. XLA propagates the shardings through the
        block scan (segment-sum binning picks up the cross-shard psum
        automatically)."""
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        band_rows = {len(b.det_index) for b in self.program.bands}

        def put(x):
            if hasattr(x, "ndim") and x.ndim >= 1 and (
                x.shape[0] == self.n_det or x.shape[0] in band_rows
            ):
                spec = P("det", *[None] * (x.ndim - 1))
            else:
                spec = P()
            return jax.device_put(x, NamedSharding(mesh, spec))

        return jax.tree.map(put, state)

    @property
    def _bin_plan(self):
        """Lazy blocked-binning geometry: computed on first use so runs
        that never pick the blocked path (CPU autos, det-sharded runs)
        never pay the setup sweep."""
        if self._bin_plan_cache == "unset":
            self._bin_plan_cache = self._setup_blocked_binning()
        return self._bin_plan_cache

    def _auto_blocked(self, mesh) -> bool:
        """Default binning mode: blocked contractions with resident run
        plans where the platform table takes them (the
        `stream_blocked_binning` gate of maria_tpu/backend.py),
        scatter-adds elsewhere. Det-sharded runs keep the scatter path
        (XLA inserts its psum). Ordered so the lazy plan is only built
        when the other gates pass."""
        from ..backend import use

        return mesh is None and use("stream_blocked_binning") and self._bin_plan is not None

    # -- checkpoint / resume -------------------------------------------
    #
    # Only the leaves a block MUTATES are persisted (noise cascade
    # states, map accumulators, Welch accumulators) — everything else in
    # the carried state (coarse fields, gains, calibration pads) is a
    # deterministic function of the run key, so resume recomputes it
    # with one init_state dispatch and overwrites the mutable subtree
    # from disk. Blocks depend only on (carried state, block index), so
    # a resumed run is exactly the uninterrupted one.

    _MUTABLE_KEYS = ("noise", "map_sum", "map_wgt", "psd_sum", "psd_blocks", "bin_lost")

    @staticmethod
    def _key_bits(key):
        try:
            return np.asarray(jax.random.key_data(key))
        except TypeError:  # old-style uint32 key array
            return np.asarray(key)

    def _fingerprint(self, use_blocked: bool = False) -> str:
        # v3: bin_lost joined the mutable leaves; the binning mode is
        # part of the identity (a blocked-mode checkpoint resumed in
        # scatter mode would blend accumulators from two float paths)
        if use_blocked:
            mode = "plan" if self._resident is not None else "mxu"
        else:
            mode = "scatter"
        return (
            f"v3:{mode}:{self.n_t}:{self.n_blocks}:{self.B}:{self.n_det}:{self.n_x}:{self.n_y}:"
            f"{self.res:.9g}:{self.center[0]:.9g}:{self.center[1]:.9g}:{self.frame}"
        )

    def _save_ckpt(self, path, state, next_block: int, key, use_blocked: bool = False):
        import os

        mut = {k: state[k] for k in self._MUTABLE_KEYS}
        leaves, _ = jax.tree.flatten(mut)
        payload = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
        tmp = f"{path}.tmp"
        np.savez(
            tmp,
            next_block=np.int64(next_block),
            fingerprint=np.str_(self._fingerprint(use_blocked)),
            key_data=self._key_bits(key),
            **payload,
        )
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)

    def _load_ckpt(self, path, state, key, use_blocked: bool = False):
        """Overwrite `state`'s mutable subtree from `path`; returns
        (state, next_block). Raises ValueError on any mismatch."""
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != self._fingerprint(use_blocked):
                raise ValueError(
                    f"checkpoint {path} was written for a different run "
                    f"({z['fingerprint']} != {self._fingerprint(use_blocked)})"
                )
            if not np.array_equal(z["key_data"], self._key_bits(key)):
                raise ValueError(f"checkpoint {path} was written with a different PRNG key")
            mut = {k: state[k] for k in self._MUTABLE_KEYS}
            leaves, treedef = jax.tree.flatten(mut)
            loaded = [z[f"leaf_{i}"] for i in range(len(leaves))]
            for cur, new in zip(leaves, loaded):
                if tuple(cur.shape) != tuple(new.shape):
                    raise ValueError(f"checkpoint {path} leaf shape mismatch: {new.shape} != {cur.shape}")
            state = dict(state)
            state.update(jax.tree.unflatten(treedef, [jnp.asarray(x) for x in loaded]))
            return state, int(z["next_block"])

    # ------------------------------------------------------------------
    def run(
        self, key=None, group_size: int = 8, mesh=None, accumulate_psd: bool = False,
        checkpoint_path=None, checkpoint_every: int = None, mxu_binning: bool = None,
    ) -> StreamingResult:
        """Synthesize + bin the whole observation, `group_size` blocks
        per device dispatch, state carried between dispatches. Pass a
        ("det", ...) `mesh` to shard the detector axis across chips —
        the streamed map then reduces with an XLA-inserted psum and the
        result equals the single-device run (tested). Det sharding needs
        equal shards: call `program.pad_detectors(n_det_shards)` before
        building the executor.

        `checkpoint_path` makes long runs resumable: accumulator state
        is written atomically every `checkpoint_every` blocks (default:
        every dispatch group), and if the file already exists for the
        SAME key and geometry the run continues where it left off — the
        result is exactly the uninterrupted run's (tested).

        `mxu_binning` selects how blocks land in the map: None (default)
        auto-picks the MXU path when the geometry allows it and no mesh
        is given (det-sharded runs keep the scatter path, whose psum XLA
        inserts); True requires it; False forces the scatter path (used
        by the equality tests). Within the MXU path, HBM-RESIDENT
        per-block run plans are precomputed at first use when they fit
        the MARIA_TPU_STREAM_PLAN_GB budget (default 6 GB; ~40 min of
        AtLAST-50k) — the batch binner's static-plan speed for streams —
        falling back to the bounded-memory in-scan windowed contraction
        beyond it (the arbitrarily-long contract). Resident precision:
        MARIA_TPU_STREAM_BIN_PRECISION = shifted (default, the batch
        headline's ~1e-4 class) | hilo (~2^-16)."""
        key = key if key is not None else jax.random.key(0)
        if mxu_binning is None:
            use_blocked = self._auto_blocked(mesh)
        elif mxu_binning:
            if self._bin_plan is None or mesh is not None:
                raise ValueError(
                    "mxu_binning=True needs a coverable window geometry and no mesh "
                    "(det-sharded runs bin through the scatter path)."
                )
            use_blocked = True
        else:
            use_blocked = False
        state = self.init_state(key)
        start_block = 0
        if checkpoint_path is not None:
            import os

            if os.path.exists(checkpoint_path):
                state, start_block = self._load_ckpt(checkpoint_path, state, key, use_blocked)
        if mesh is not None:
            state = self._shard_state(state, mesh)
        last_saved = start_block
        for g1, state in self._iterate(
            state, group_size, with_tod=False, with_psd=accumulate_psd,
            start_block=start_block, use_blocked=use_blocked,
        ):
            if checkpoint_path is not None and g1 < self.n_blocks and (
                g1 - last_saved >= (checkpoint_every or group_size)
            ):
                # the save already syncs the host, so the window-bound
                # check is free here — fail NOW rather than after the
                # remaining (possibly hours of) stream, and never write
                # a checkpoint holding poisoned accumulators
                self._check_lost(state)
                self._save_ckpt(checkpoint_path, state, g1, key, use_blocked)
                last_saved = g1
        self._check_lost(state)
        psd_freqs = psds = None
        if accumulate_psd:
            n_blocks = max(float(state["psd_blocks"]), 1.0)
            psd_freqs = np.fft.rfftfreq(self.B, d=1.0 / self.program.sample_rate)
            psds = [np.asarray(s) / n_blocks for s in state["psd_sum"]]
        return StreamingResult(
            map_sum=np.asarray(state["map_sum"]).reshape(self.n_y, self.n_x),
            map_wgt=np.asarray(state["map_wgt"]).reshape(self.n_y, self.n_x),
            n_samples=self.n_real_det * self.n_t,
            n_x=self.n_x, n_y=self.n_y, center=self.center, res=self.res,
            psd_freqs=psd_freqs, psds=psds,
        )

    @staticmethod
    def _check_lost(state):
        lost = float(state["bin_lost"])
        if lost:
            raise RuntimeError(
                f"MXU-binning window dropped {lost:.0f} in-map samples — the static "
                "window bound was violated (unexpected; the setup bounds it from the "
                "exact pointing plus stride/rotation margins). Re-run with "
                "mxu_binning=False (and a fresh checkpoint_path, if any) and report "
                "the configuration."
            )

    def tod_blocks(self, key=None, group_size: int = 1):
        """Yield (block_index, tod_block (n_det, <=B) pW) in stream order
        — the lazy-TOD analogue of the reference's dask fields."""
        state = self.init_state(key if key is not None else jax.random.key(0))
        b = 0
        for state, tods, n_real in self._iterate(
            state, group_size, with_tod=True, yield_tod=True,
            use_blocked=self._auto_blocked(None),
        ):
            for tod in np.asarray(tods)[:n_real]:  # drop phantom tail blocks
                hi = min(self.B, self.n_t - b * self.B)
                yield b, np.asarray(tod)[:, :hi]
                b += 1

    def _xs_groups(self, start_block: int, group_size: int):
        """Yield (g0, g1, xs) per dispatch group of EXACTLY L blocks: the
        tail group is padded with phantom blocks (b >= n_blocks) whose
        samples the block fn fully masks (g < n_t) — so one executor
        compiles ONE scan shape per mode instead of re-specializing (a
        second full compile) on the leftover tail length. Phantom blocks only ever run after the last real
        block, so the carried state the real blocks see is untouched.
        Shared by run()/tod_blocks() and the streamed ML mapper's
        passes (mappers/streaming_ml.py)."""
        az = self.bs_az_f.reshape(self.n_blocks, self.B)
        el = self.bs_el_f.reshape(self.n_blocks, self.B)
        need_tracks = self.sky is not None or self.frame == "ra/dec"
        sky_ext = self._sky_track_blocks() if need_tracks else None
        L = min(group_size, max(self.n_blocks - start_block, 1))

        def take(a, g0, g1):
            out = a[g0:g1]
            if g1 - g0 < L:
                out = np.concatenate([out, np.repeat(out[-1:], L - (g1 - g0), axis=0)])
            return jnp.asarray(out)

        for g0 in range(start_block, self.n_blocks, L):
            g1 = min(g0 + L, self.n_blocks)
            bs = jnp.arange(g0, g0 + L)
            xs = (bs, take(az, g0, g1), take(el, g0, g1))
            if sky_ext is not None:
                xs = (*xs, tuple(take(a, g0, g1) for a in sky_ext))
            yield g0, g1, xs

    def _iterate(
        self, state, group_size: int, with_tod: bool, yield_tod: bool = False,
        with_psd: bool = False, start_block: int = 0, use_blocked: bool = False,
    ):
        run_group = self._group_fn(with_tod, with_psd, use_blocked)
        plans = self._plan_args(use_blocked)
        for g0, g1, xs in self._xs_groups(start_block, group_size):
            state, tods = run_group(state, xs, plans)
            if yield_tod:
                yield state, tods, g1 - g0
            else:
                yield g1, state

    def _sky_track_blocks(self):
        """Overlapping ext-grid track slices per block: block b covers
        fine indices [b*B - r, (b+1)*B + r) (the integration-kernel
        halo), realized as stride tricks over r-edge-padded tracks."""
        if getattr(self, "_sky_blocks_cache", None) is not None:
            return self._sky_blocks_cache
        r, B = self.r, self.B

        def ext_blocks(track):
            padded = np.pad(track, (r, r), mode="edge")
            return np.stack(
                [padded[b * B : (b + 1) * B + 2 * r] for b in range(self.n_blocks)]
            )

        zeros = np.zeros(self.n_blocks * self.B, dtype=np.float32)
        ra = self.bs_ra_f if self.bs_ra_f is not None else zeros
        dec = self.bs_dec_f if self.bs_dec_f is not None else zeros
        q = self.q_f if self.q_f is not None else zeros
        tracks = [ra, dec, q, self.bs_az_f, self.bs_el_f]
        if self._map_fi_f is not None:  # time-evolving map frame blend
            tracks += [self._map_fi_f, self._map_whi_f]
        self._sky_blocks_cache = tuple(ext_blocks(t) for t in tracks)
        return self._sky_blocks_cache
