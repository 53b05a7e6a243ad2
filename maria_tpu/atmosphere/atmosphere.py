"""Correlated atmospheric emission
(reference: maria/atmosphere/atmosphere.py:31-380; arXiv:2111.01319).

`Atmosphere.initialize(obs)` does the host-side geometry: layer table,
per-process wind, the closed-form aligning rotation (PCA replaces the
reference's SLSQP search), and static screen grids. `simulate_pwv(key)`
is a single jit-compiled program: per layer, draw a Matérn screen (FFT
path, beam smoothing fused into the spectral weights) or run the AR
extrusion, then bilinear-gather it at the wind-advected line-of-sight
positions of every (detector, coarse-time) sample and accumulate into
zenith-scaled PWV.
"""

from __future__ import annotations

import logging
import os
import time as _time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..coords.transforms import offsets_to_phi_theta, offsets_to_phi_theta_jit
from ..spectrum import AtmosphericSpectrum
from ..units import Quantity
from ..weather import Weather
from .fourier import (
    band_split_spectral_weights_2d,
    field_spectral_weights_2d,
    good_fft_size,
    layered_field_spectral_weights,
)
from .layers import generate_layers
from .process import AutoregressiveProcess
from .sampling import accumulate_pwv

logger = logging.getLogger("maria_tpu")

# Minimum periodic extent of an FFT screen, in units of the outer scale
# r0. A footprint-sized box cannot carry the Matérn spectrum: its
# longest mode is the box itself, so every scale between the box and
# ~r0 — which DOMINATE the aperture-smoothed structure function — is
# simply absent. Measured on the ν=1/3, r0=1 km, 42.5 m-aperture case
# (tests/test_atmosphere_fidelity.py): a 240 m footprint box yields
# 4% of the analytic D^(1/2)(60 m) and 0.7% of the field variance;
# 4·r0 recovers 95% of D^(1/2), 5·r0 98%. Scales beyond the box fold
# into the weather-level mean-pwv draw, not the screens.
_MIN_EXTENT_R0_FACTOR = 4.0
# memory guard: a screen axis never exceeds this many cells from the
# extent rule alone (65 MB of f32 at 4096² — far above any real scene)
_MAX_EXTENT_CELLS = 4096


def _min_spectral_extent_cells(res: float, r0: float) -> int:
    import os

    factor = float(os.environ.get("MARIA_TPU_SCREEN_EXTENT_R0", _MIN_EXTENT_R0_FACTOR))
    return int(min(factor * r0 / max(res, 1e-6), _MAX_EXTENT_CELLS))

SUPPORTED_MODELS = ["2d", "3d"]
SUPPORTED_METHODS = ["fourier", "ar"]


@dataclass
class LayerScreen:
    """Static per-layer synthesis geometry (host-built)."""

    h: float
    z: float
    res: float
    pwv_rms: float
    angle: float  # rotation of the extrusion frame
    vx: float  # wind east, m/s
    vy: float  # wind north, m/s
    tx_min: float
    ty_min: float
    nx: int  # extrusion-axis points (padded fft size)
    ny: int  # cross-axis points
    W: np.ndarray = None  # spectral weights (fourier path)
    process: AutoregressiveProcess = None  # ar path
    ar_columns: slice = None  # this layer's columns in the process cross-section
    ty_res: float = None  # cross-axis spacing (may differ from res)
    beam_sigma: float = 0.0
    # static window sizes (cells) for the boresight-tracked windowed
    # sampler; None disables windowing for this screen
    win_x: int = None
    win_y: int = None
    # footprint-sized grid (before FFT padding): what a non-FFT method
    # (e.g. the reference's AR extrusion) actually needs to cover
    nx_needed: int = None
    ny_needed: int = None
    # spectral band this screen carries: "full" (one screen spans the
    # whole spectrum), or one of a "fine"/"coarse" PAIR covering the
    # same layer (fourier.band_split_spectral_weights_2d) — the
    # CPU-reference baseline models each layer once and skips "coarse"
    band: str = "full"


@dataclass
class ScreenGroup:
    """A vertically-correlated stack of layer screens on a common grid
    (the fourier 3-D model): slices of one 3-D Matérn field, synthesized
    jointly via `fourier.synthesize_layered_matern_2d`."""

    heights: np.ndarray  # (L,) layer heights above the site
    zs: np.ndarray  # (L,) line-of-sight distances
    pwv_rms: np.ndarray  # (L,)
    angle: float
    vx: float
    vy: float
    res: float
    tx_min: float
    ty_min: float
    nx: int
    ny: int
    W: np.ndarray  # (J, ny, nx//2+1) per-node spectral amplitudes
    M_cos: np.ndarray  # (L, J)
    M_sin: np.ndarray  # (L, J)
    beam: np.ndarray = None  # (L, ny, nx//2+1)
    win_x: np.ndarray = None  # (L,) static window sizes per layer
    win_y: np.ndarray = None
    # (L,) per-layer temporal decimation factors for the windowed group
    # sampler: layer l is sampled every dec[l]-th coarse step (its LOS
    # drift per decimated step stays under a fraction of a cell) and
    # linearly upsampled. None = no decimation.
    dec: np.ndarray = None
    # (L,) bools: layer qualifies for the static-hat GEMM sampler — its
    # per-detector offsets drift < sampler_dec_tol cells over the whole
    # observation AND the boresight window never clips the screen edge
    # (sampling._sample_group_static). None = never.
    hat_static: np.ndarray = None


class Atmosphere:
    def __init__(
        self,
        model: str = "2d",
        timestamp: float = None,
        region: str = "princeton",
        altitude: float = None,
        weather: dict = {},
        weather_quantiles: dict = {},
        weather_source: str = "synthetic",
        spectrum_source: str = "synthetic/v1",
        pwv_rms_frac: float = 0.03,
        max_height: float = 5e3,
        timestep: float = None,
        method: str = "fourier",
        n_layers: int = None,
        min_height: float = None,
        outer_scale: float = None,
        seed: int = None,
        disable_progress_bars: bool = True,
        sampler_dec_tol: float = None,
    ):
        if model not in SUPPORTED_MODELS:
            raise ValueError(f"Invalid model '{model}'. Supported models are {SUPPORTED_MODELS}.")
        if method not in SUPPORTED_METHODS:
            raise ValueError(f"Invalid method '{method}'. Supported methods are {SUPPORTED_METHODS}.")

        self.model = model
        self.method = method
        self.spectrum = AtmosphericSpectrum(region=region, source=spectrum_source)
        self.weather = Weather(
            time=timestamp if timestamp is not None else _time.time(),
            region=region,
            altitude=altitude,
            override=weather,
            quantiles=weather_quantiles,
            source=weather_source,
        )
        self.pwv_rms_frac = pwv_rms_frac
        self.max_height = max_height
        self.min_height = min_height
        # reference exposes `turbulent_outer_scale` (sim/params.yml); when
        # unset we use the height-dependent default max(1km, 300+h/10)
        self.outer_scale = outer_scale
        self.timestep = timestep
        # the 3-D model defaults to 12 log-spaced slabs: the fourier path
        # carries vertical correlation in its cross-spectra and the AR
        # path in its stacked cross-section covariance, so neither needs
        # the reference's resolution-matched stack (hundreds of layers,
        # O(n^3) covariance setup) to converge the pwv integral
        self.n_layers = n_layers if n_layers is not None else (12 if model == "3d" else None)
        self.seed = seed
        # per-layer temporal decimation tolerance for the windowed group
        # sampler, in CELLS of LOS drift per decimated step (see
        # sampling._sample_group_windowed). 0 disables decimation.
        if sampler_dec_tol is None:
            sampler_dec_tol = float(os.environ.get("MARIA_TPU_SAMPLER_DEC_TOL", "0.35"))
        self.sampler_dec_tol = sampler_dec_tol
        self._initialized = False

    def initialize(self, obs):
        init_s = _time.monotonic()
        self.layers = generate_layers(
            instrument=obs.instrument,
            boresight=obs.boresight,
            weather=self.weather,
            site=obs.site,
            mode=self.model,
            max_height=self.max_height,
            pwv_rms_frac=self.pwv_rms_frac,
            n_layers=self.n_layers,
            min_height=self.min_height,
        )

        if self.timestep is None:
            min_fwhm = float(obs.instrument.dets.angular_fwhm(z=self.max_height).rad.min())
            max_wind = float((self.layers.wind_speed / self.layers.h).max())
            self.timestep = max(1e-1, min_fwhm / max_wind)
            # snap to an integer multiple of the TOD sample interval so the
            # fused program can use the gather-free phase-stencil upsample
            dt_f = 1.0 / float(obs.sample_rate)
            self.timestep = max(dt_f, round(self.timestep / dt_f) * dt_f)

        self.boresight = obs.boresight.downsample(timestep=self.timestep)
        n_t = self.boresight.shape[-1]
        dt = self.timestep

        offsets = obs.instrument.dets.offsets  # (n_det, 2)
        outer_offsets = obs.instrument.dets.outer().offsets

        # coarse boresight az/el (host float64, cheap)
        bs_az = np.asarray(self.boresight.az)
        bs_el = np.asarray(self.boresight.el)

        # outer-detector pointing for hull bounds — numpy on purpose:
        # this is host-side setup on a small hull, and reading back the
        # jit version would compile and dispatch for a result the host
        # reads straight back
        pt = offsets_to_phi_theta(outer_offsets[:, None, :], bs_az, bs_el)
        hull_az, hull_el = pt[..., 0], pt[..., 1]
        # unit-height projection: x=East, y=North
        cot_el = 1 / np.tan(np.clip(hull_el, np.radians(5), None))
        hull_px = np.sin(hull_az) * cot_el  # (n_outer, n_t)
        hull_py = np.cos(hull_az) * cot_el
        # boresight track (window centers for the windowed sampler)
        bs_cot = 1 / np.tan(np.clip(bs_el, np.radians(5), None))
        bs_px = np.sin(bs_az) * bs_cot
        bs_py = np.cos(bs_az) * bs_cot

        self.screens: list[LayerScreen] = []
        self.groups: list[ScreenGroup] = []

        w = self.layers.total_water * self.layers.temperature
        t_rel = dt * np.arange(n_t)

        for process_index in sorted(np.unique(self.layers.process_index)):
            in_process = self.layers.process_index == process_index
            process_layers = self.layers.loc[in_process]

            # mass-weighted process wind (constant in time; reference
            # atmosphere.py:128-151 with angular=False)
            wp = w[in_process]
            vx = float((process_layers.wind_east * wp).sum() / wp.sum())
            vy = float((process_layers.wind_north * wp).sum() / wp.sum())

            # hull of wind-advected LOS points at the extreme layer heights
            hs = [process_layers.h[0], process_layers.h[-1]]
            pts = []
            for h in {hs[0], hs[-1]}:
                px = h * hull_px + vx * t_rel
                py = h * hull_py + vy * t_rel
                pts.append(np.stack([px.ravel(), py.ravel()], axis=-1))
            pts = np.concatenate(pts, axis=0)

            # closed-form aligning rotation: extrusion axis = principal axis
            from ..utils import principal_angle_2d

            angle = float(principal_angle_2d(pts))
            ca, sa = np.cos(angle), np.sin(angle)
            tx = ca * pts[:, 0] + sa * pts[:, 1]
            ty = -sa * pts[:, 0] + ca * pts[:, 1]

            outer_scale = self.outer_scale or max(1e3, 300 + float(process_layers.h.mean()) / 10)
            nu = 5 / 6 if self.model == "2d" else 1 / 3

            def window_bounds(h, res, nx, ny):
                # windowed-sampler bound: max offset of any detector's
                # footprint point from the boresight track, per axis of
                # the rotated frame (hull points bound all detectors)
                rel_x = h * (hull_px - bs_px[None])
                rel_y = h * (hull_py - bs_py[None])
                span_x = float(np.abs(ca * rel_x + sa * rel_y).max())
                span_y = float(np.abs(-sa * rel_x + ca * rel_y).max())
                win_x = min(nx, int(-(-(2 * span_x / res + 6) // 8) * 8))
                win_y = min(ny, int(-(-(2 * span_y / res + 6) // 8) * 8))
                return win_x, win_y

            def static_hat_ok(h, res):
                # static-hat GEMM sampler validity
                # (sampling._sample_group_static): every detector's
                # unit-height offset from the boresight, at height h,
                # drifts less than sampler_dec_tol cells from its
                # whole-observation mean (field rotation + projection
                # stretch; hull detectors bound the array). Window-edge
                # clipping is handled by the sampler's zero-pad.
                tol = self.sampler_dec_tol
                if not tol:
                    return False
                rel_x = h * (hull_px - bs_px[None])
                rel_y = h * (hull_py - bs_py[None])
                ru = ca * rel_x + sa * rel_y
                rv = -sa * rel_x + ca * rel_y
                drift = max(
                    float(np.abs(ru - ru.mean(-1, keepdims=True)).max()),
                    float(np.abs(rv - rv.mean(-1, keepdims=True)).max()),
                ) / res
                return drift <= tol

            def layer_decimation(h, res):
                # largest power-of-2 temporal decimation whose per-step
                # LOS drift (scan motion at height h + wind), measured
                # on the actual hull trajectories, stays under
                # sampler_dec_tol cells — the windowed group sampler
                # then samples this layer every dec-th coarse step and
                # lerps (sampling._sample_group_windowed)
                tol = self.sampler_dec_tol
                if not tol or n_t < 3:
                    return 1
                ddx = h * np.diff(hull_px, axis=-1) + vx * dt
                ddy = h * np.diff(hull_py, axis=-1) + vy * dt
                du = ca * ddx + sa * ddy
                dv = -sa * ddx + ca * ddy
                drift = max(float(np.abs(du).max()), float(np.abs(dv).max())) / res
                d = 1
                while 2 * d * drift <= tol and d < 16:
                    d *= 2
                return d

            if self.model == "2d":
                # one independent 2-D screen per layer (fourier: FFT
                # synthesis with beam smoothing folded into the spectral
                # weights; ar: per-slab conditional-Gaussian extrusion,
                # reference maria/atmosphere/extrusion.py:66-68)
                for _, layer in process_layers.iterrows():
                    res = float(layer.res)
                    margin = 2 * res
                    tx_min, tx_max = tx.min() - margin, tx.max() + margin
                    ty_min, ty_max = ty.min() - margin, ty.max() + margin
                    nx_needed = int((tx_max - tx_min) / res) + 2
                    ny_needed = int((ty_max - ty_min) / res) + 2

                    beam_fwhm = float(obs.instrument.dets.physical_fwhm(layer.z).m.mean())
                    beam_sigma = beam_fwhm / 2.355

                    if self.method == "ar":
                        nx, ny = nx_needed, ny_needed
                        cross_side = ty_min + res * np.arange(ny)
                        process = AutoregressiveProcess(
                            cross_section=np.stack(
                                [cross_side, np.full(ny, float(layer.h))], axis=-1
                            ),
                            extrusion=tx_min + res * np.arange(nx),
                            callback_kwargs={"nu": nu, "r0": outer_scale},
                        )
                        self.screens.append(
                            LayerScreen(
                                h=float(layer.h), z=float(layer.z), res=res,
                                pwv_rms=float(layer.pwv_rms), angle=angle, vx=vx, vy=vy,
                                tx_min=tx_min, ty_min=ty_min, nx=nx, ny=ny,
                                process=process, ar_columns=slice(0, ny),
                                ty_res=res, beam_sigma=beam_sigma,
                            )
                        )
                        continue

                    min_cells = _min_spectral_extent_cells(res, outer_scale)
                    nx_fp = good_fft_size(max(int(1.3 * nx_needed) + 8, 32))
                    ny_fp = good_fft_size(max(int(1.3 * ny_needed) + 8, 32))

                    if min_cells > 2 * max(nx_fp, ny_fp):
                        # footprint box << spectral extent: carry the
                        # spectrum as a fine/coarse band PAIR (the
                        # single big box regressed small scenes 3.7x —
                        # fourier.band_split_spectral_weights_2d).
                        # Balance the pair: the coarse box is
                        # (8 min_cells res / L_min)^2 cells, so growing
                        # the SHORT fine axis shrinks it quadratically —
                        # pick the total-cells minimizer.
                        def pair_sizes(t):
                            ny_t, nx_t = max(ny_fp, t), max(nx_fp, t)
                            res_ct = min(ny_t, nx_t) * res / 8.0
                            cc = good_fft_size(int(min_cells * res / res_ct) + 2)
                            return ny_t, nx_t, res_ct, cc

                        cands = sorted({good_fft_size(t) for t in (
                            min(nx_fp, ny_fp), 48, 64, 96, 128, 192, 256)})
                        ny_fp, nx_fp, res_c, cells_c = min(
                            (pair_sizes(t) for t in cands if t <= max(min_cells, 32)),
                            key=lambda s: s[0] * s[1] + s[3] ** 2,
                        )
                        L_min = min(nx_fp, ny_fp) * res
                        k_c = 4 * np.pi / L_min
                        W_f, W_c = band_split_spectral_weights_2d(
                            ny_fp, nx_fp, res, cells_c, cells_c, res_c,
                            k_c, nu=nu, r0=outer_scale, beam_sigma=beam_sigma,
                        )
                        win_x, win_y = window_bounds(float(layer.h), res, nx_fp, ny_fp)
                        win_xc, win_yc = window_bounds(
                            float(layer.h), res_c, cells_c, cells_c)
                        common = dict(
                            h=float(layer.h), z=float(layer.z),
                            pwv_rms=float(layer.pwv_rms), angle=angle, vx=vx, vy=vy,
                        )
                        self.screens.append(
                            LayerScreen(
                                res=res, tx_min=tx_min, ty_min=ty_min,
                                nx=nx_fp, ny=ny_fp, W=W_f,
                                win_x=win_x, win_y=win_y,
                                nx_needed=nx_needed, ny_needed=ny_needed,
                                band="fine", **common,
                            )
                        )
                        # coarse box centered on the footprint
                        Lc = cells_c * res_c
                        self.screens.append(
                            LayerScreen(
                                res=res_c,
                                tx_min=tx_min - (Lc - nx_fp * res) / 2,
                                ty_min=ty_min - (Lc - ny_fp * res) / 2,
                                nx=cells_c, ny=cells_c, W=W_c,
                                win_x=win_xc, win_y=win_yc,
                                band="coarse", **common,
                            )
                        )
                        continue

                    nx = good_fft_size(max(nx_fp, min_cells))
                    ny = good_fft_size(max(ny_fp, min_cells))

                    W = field_spectral_weights_2d(
                        ny, nx, res, res, nu=nu, r0=outer_scale, beam_sigma=beam_sigma
                    )

                    win_x, win_y = window_bounds(float(layer.h), res, nx, ny)

                    self.screens.append(
                        LayerScreen(
                            h=float(layer.h), z=float(layer.z), res=res,
                            pwv_rms=float(layer.pwv_rms), angle=angle, vx=vx, vy=vy,
                            tx_min=tx_min, ty_min=ty_min, nx=nx, ny=ny, W=W,
                            win_x=win_x, win_y=win_y,
                            nx_needed=nx_needed, ny_needed=ny_needed,
                        )
                    )
            elif self.method == "fourier":
                # fourier 3-D: one vertically-correlated stack per process
                # — slices of a single 3-D Matérn field on a common grid,
                # mixed per layer from kz-quadrature fields (one matmul).
                # The device replacement for the reference's stacked-
                # cross-section AR process (atmosphere.py:203-257).
                res = float(process_layers.res.min())
                margin = 2 * res
                tx_min, tx_max = tx.min() - margin, tx.max() + margin
                ty_min, ty_max = ty.min() - margin, ty.max() + margin
                min_cells = _min_spectral_extent_cells(res, outer_scale)
                nx = good_fft_size(max(int(1.3 * ((tx_max - tx_min) / res + 2)) + 8, min_cells))
                ny = good_fft_size(max(int(1.3 * ((ty_max - ty_min) / res + 2)) + 8, min_cells))

                heights = process_layers.h.astype(float)
                zs = process_layers.z.astype(float)
                beam_sigmas = np.array(
                    [
                        float(obs.instrument.dets.physical_fwhm(z).m.mean()) / 2.355
                        for z in zs
                    ]
                )
                W, M_cos, M_sin, beam = layered_field_spectral_weights(
                    ny, nx, res, res, heights, nu=nu, r0=outer_scale, beam_sigmas=beam_sigmas
                )
                wins = np.array([window_bounds(h, res, nx, ny) for h in heights], dtype=int)
                dec = np.array([layer_decimation(h, res) for h in heights], dtype=int)
                hat_static = np.array(
                    [static_hat_ok(h, res) for h in heights], dtype=bool
                )
                self.groups.append(
                    ScreenGroup(
                        heights=heights, zs=zs,
                        pwv_rms=process_layers.pwv_rms.astype(float),
                        angle=angle, vx=vx, vy=vy, res=res,
                        tx_min=tx_min, ty_min=ty_min, nx=nx, ny=ny,
                        W=W, M_cos=M_cos, M_sin=M_sin, beam=beam,
                        win_x=wins[:, 0], win_y=wins[:, 1], dec=dec,
                        hat_static=hat_static,
                    )
                )
            else:
                # 3d AR: one conditional-Gaussian process over the stacked
                # cross-section (reference atmosphere.py:203-257)
                res_min = float(process_layers.res.min())
                extrusion = np.arange(tx.min() - 2 * res_min, tx.max() + 2 * res_min, res_min)
                cross_list, col_slices = [], []
                start = 0
                for _, layer in process_layers.iterrows():
                    n_cross = max(2, int((ty.max() - ty.min() + 2 * layer.res) / layer.res))
                    cross_side = np.linspace(ty.min() - layer.res, ty.max() + layer.res, n_cross)
                    cross_list.append(
                        np.stack([cross_side, np.full(n_cross, layer.h)], axis=-1)
                    )
                    col_slices.append(slice(start, start + n_cross))
                    start += n_cross
                process = AutoregressiveProcess(
                    cross_section=np.concatenate(cross_list, axis=0),
                    extrusion=extrusion,
                    callback_kwargs={"nu": nu, "r0": outer_scale},
                )
                for (_, layer), cols, cross in zip(process_layers.iterrows(), col_slices, cross_list):
                    beam_fwhm = float(obs.instrument.dets.physical_fwhm(layer.z).m.mean())
                    self.screens.append(
                        LayerScreen(
                            h=float(layer.h), z=float(layer.z), res=res_min,
                            pwv_rms=float(layer.pwv_rms), angle=angle, vx=vx, vy=vy,
                            tx_min=float(extrusion[0]), ty_min=float(cross[0, 0]),
                            nx=len(extrusion), ny=cols.stop - cols.start,
                            process=process, ar_columns=cols,
                            ty_res=float(cross[1, 0] - cross[0, 0]),
                            beam_sigma=beam_fwhm / 2.355,
                        )
                    )

        self._det_offsets = jnp.asarray(offsets, dtype=jnp.float32)
        self._bs_az = jnp.asarray(bs_az, dtype=jnp.float32)
        self._bs_el = jnp.asarray(bs_el, dtype=jnp.float32)
        self._t_rel = jnp.asarray(t_rel, dtype=jnp.float32)
        self._initialized = True
        logger.debug(f"Initialized atmosphere ({len(self.screens)} screens) in {_time.monotonic() - init_s:.2f} s")

    # -- device program ---------------------------------------------------------
    def _sample_screens(self, key, det_az, det_el, ar_screens):
        """Accumulate pwv over layers via the shared sampler
        (`sampling.accumulate_pwv`, the same code the fused TODProgram
        runs); pure jnp, called under jit."""
        cot_el = 1 / jnp.tan(jnp.clip(det_el, jnp.radians(5.0), None))
        px = jnp.sin(det_az) * cot_el  # (n_det, n_t), unit height
        py = jnp.cos(det_az) * cot_el
        bs_cot = 1 / jnp.tan(jnp.clip(self._bs_el, jnp.radians(5.0), None))
        bs_px = jnp.sin(self._bs_az) * bs_cot
        bs_py = jnp.cos(self._bs_az) * bs_cot
        return accumulate_pwv(
            key, self.weather.pwv, self.screens, self.groups,
            px, py, bs_px, bs_py, self._t_rel, ar_values=ar_screens,
        )

    def simulate_pwv(self, instrument=None, key=None) -> jnp.ndarray:
        """Zenith-scaled PWV per (detector, coarse time), in mm."""
        if not self._initialized:
            raise RuntimeError("Atmosphere must be initialized with an observation.")
        key = key if key is not None else jax.random.key(
            self.seed if self.seed is not None else np.random.randint(2**31)
        )

        # AR processes (if any) run their sequential scans first
        ar_screens = {}
        ran = {}
        for i, screen in enumerate(self.screens):
            if screen.process is not None:
                if id(screen.process) not in ran:
                    key, sub = jax.random.split(key)
                    ran[id(screen.process)] = screen.process.run(sub)
                values = ran[id(screen.process)]  # (n_extrusion, n_cross_total)
                ar_screens[i] = values[:, screen.ar_columns].T  # (ny, nx)

        pt = offsets_to_phi_theta_jit(self._det_offsets[:, None, :], self._bs_az, self._bs_el)
        det_az, det_el = pt[..., 0], pt[..., 1]

        self.zenith_scaled_pwv = self._sample_screens(key, det_az, det_el, ar_screens)
        self.det_el = det_el
        return self.zenith_scaled_pwv

    def __repr__(self):
        n_screens = len(getattr(self, "screens", []))
        n_screens += sum(len(g.heights) for g in getattr(self, "groups", []))
        return (
            f"Atmosphere(model={self.model}, method={self.method}, {n_screens} screens):\n"
            f"  spectrum region: {self.spectrum.region}\n"
            f"  weather: {self.weather!r}\n"
            f"  pwv rms frac: {self.pwv_rms_frac}"
        )
