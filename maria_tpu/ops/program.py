"""The fused TOD-synthesis program.

Assembles an Observation into ONE jit-compiled function
key -> per-field detector loadings, so the whole hot path (screen FFTs,
line-of-sight gathers, PWV upsampling, bandpass interpolation, noise
FFTs, Mueller weighting) compiles into a single XLA program with no
host round-trips — the device counterpart of the reference's
per-stage numpy pipeline (maria/sim/simulation.py:213-247).

All (n_det,)-shaped inputs may be sharded over a ("det", "time") mesh;
the program contains no cross-detector dependencies except the final
map binning (a segment-sum that XLA turns into partial sums + psum).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..atmosphere.sampling import accumulate_pwv
from ..noise import generate_noise_with_knee
from .interp import (
    RegularGridInterpolator,
    upsample_time,
    upsample_time_phases,
)

logger = logging.getLogger("maria_tpu")


@dataclass
class BandBlock:
    """Static per-band data for the program."""

    name: str
    det_index: np.ndarray  # indices into the detector axis

    @property
    def det_sel(self):
        """Static selector for traced arrays: a SLICE when this band's
        detectors are contiguous (no i32 index constant in the HLO, no
        gather), else the index array."""
        idx = self.det_index
        if len(idx) and np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
            return slice(int(idx[0]), int(idx[-1] + 1))
        return idx
    pwv_side: jnp.ndarray
    el_side: jnp.ndarray
    power_table: jnp.ndarray  # (n_pwv, n_el) pW
    NEP: float
    knee: float
    noise_basis: np.ndarray = None
    corr_prop: float = 0.0
    NEP_per_loading: float = 0.0  # W√s per W of loading (reference sim/noise.py:33)
    # fused CMB stage: static sky timelines + (pwv, el) calibration tables
    cmb_samples: np.ndarray = None  # (n_band_det, n_t) Stokes-weighted K_CMB
    cmb_P0_table: np.ndarray = None  # (n_pwv, n_el) pW at T_CMB
    cmb_dPdT_table: np.ndarray = None  # (n_pwv, n_el) pW / K_CMB
    # fused input-map stage:
    # [(table (n_pwv, n_el) pW/K_RJ, samples (n_band_det, n_t), eval|None)]
    map_stages: list = None
    # gather-free (pwv, el) -> value evaluators (ops/interp.make_table_eval),
    # built at program assembly; fall back to gather bilinear when absent
    power_eval: object = None
    cmb_P0_eval: object = None
    cmb_dPdT_eval: object = None


@dataclass
class TODProgram:
    """Static scene -> jitted key -> loadings."""

    screens: list  # LayerScreen list (fourier W screens and/or AR screens)
    mean_pwv: float
    t_coarse: np.ndarray  # relative seconds, (n_tc,)
    t_fine: np.ndarray  # relative seconds, (n_t,)
    offsets: np.ndarray  # (n_det, 2)
    bs_az_coarse: np.ndarray
    bs_el_coarse: np.ndarray
    mueller_I: np.ndarray  # (n_det,)
    groups: list = field(default_factory=list)  # ScreenGroup list (fourier 3-D)
    bands: list = field(default_factory=list)
    sample_rate: float = 50.0
    with_noise: bool = True
    gain_error: np.ndarray = None

    def __post_init__(self):
        self._noise_specs_cache = None  # invalidated on re-init (pad_detectors)
        # integer coarse/fine upsample ratio enables the gather-free
        # phase-stencil path
        if len(self.t_coarse) > 1 and len(self.t_fine) > 1:
            dt_c = float(np.mean(np.diff(self.t_coarse)))
            dt_f = float(np.mean(np.diff(self.t_fine)))
            ratio = max(1, int(round(dt_c / dt_f)))
            aligned = np.allclose(
                self.t_coarse,
                self.t_fine[0] + np.arange(len(self.t_coarse)) * ratio * dt_f,
                atol=0.01 * dt_f,
            )
            self.upsample_ratio = ratio if aligned else None
        else:
            self.upsample_ratio = None

        # bands whose detectors form contiguous, ordered slices let the
        # program assemble per-band results by concatenation (no scatter)
        order = sorted(range(len(self.bands)), key=lambda i: self.bands[i].det_index[0] if len(self.bands[i].det_index) else 0)
        covered = []
        for i in order:
            idx = self.bands[i].det_index
            if len(idx) == 0 or not np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
                self.band_order = None
                return
            covered.append((int(idx[0]), int(idx[-1] + 1)))
        is_partition = (
            covered
            and covered[0][0] == 0
            and covered[-1][1] == len(self.offsets)
            and all(a[1] == b[0] for a, b in zip(covered[:-1], covered[1:]))
        )
        self.band_order = order if is_partition else None

    def pad_detectors(self, multiple: int) -> int:
        """Pad the detector axis to a multiple of the mesh's det-shard
        count (equal shards need equal rows). Padded detectors replicate
        the LAST detector — same band, same pointing — and must be
        excluded from maps downstream (mark their pixels negative).
        Call BEFORE device_tables(). Returns the number of padded rows.

        Note: padding changes the shapes of the noise/gain draws, so a
        padded program is a DIFFERENT realization from the unpadded one
        for the same key (the turbulence screens are unaffected). All
        sharded-vs-unsharded comparisons must use the same padded
        program on both sides."""
        n_det = len(self.offsets)
        pad = -n_det % multiple
        if not pad:
            return 0
        self.n_real_det = n_det  # consumers mask rows >= n_real_det out of maps
        self.offsets = np.pad(self.offsets, ((0, pad), (0, 0)), mode="edge")
        self.mueller_I = np.pad(self.mueller_I, (0, pad), mode="edge")
        if self.gain_error is not None:
            self.gain_error = np.pad(np.asarray(self.gain_error), (0, pad), mode="edge")
        band = max(
            self.bands,
            key=lambda b: b.det_index[-1] if len(b.det_index) else -1,
        )
        band.det_index = np.concatenate(
            [band.det_index, n_det + np.arange(pad)]
        ).astype(band.det_index.dtype)

        def pad_rows(a):
            return None if a is None else np.pad(np.asarray(a), ((0, pad), (0, 0)), mode="edge")

        band.cmb_samples = pad_rows(band.cmb_samples)
        band.noise_basis = pad_rows(band.noise_basis)
        if band.map_stages:
            band.map_stages = [
                (table, pad_rows(samples), ev) for (table, samples, ev) in band.map_stages
            ]
        self.__post_init__()  # recompute band contiguity + upsample ratio
        return pad

    def band_bounds(self):
        """Contiguous (start, stop) detector slices in band_order, or
        None when bands do not partition the axis — the `order_groups`
        input for a band-stable binning plan."""
        if self.band_order is None:
            return None
        return [
            (int(self.bands[i].det_index[0]), int(self.bands[i].det_index[-1] + 1))
            for i in self.band_order
        ]

    def permute_detectors(self, perm) -> None:
        """Reorder the detector axis so row i is the old row perm[i].

        With a BAND-STABLE perm (each band's rows stay inside the band's
        slice — e.g. a binning plan built with order_groups =
        band_bounds()), the program then emits TOD directly in the
        plan's det-blocked order and `bin_runchunk(...,
        data_in_plan_order=True)` consumes the synthesis layout with no
        row-gather relayout. Maps are pixel-space, so nothing needs
        un-permuting downstream; per-detector PRNG streams follow the
        row index, so a permuted program is a different realization of
        the same process for the same key."""
        perm = np.asarray(perm)
        if perm.shape != (len(self.offsets),):
            raise ValueError(f"perm must have shape ({len(self.offsets)},)")
        self.offsets = np.asarray(self.offsets)[perm]
        self.mueller_I = np.asarray(self.mueller_I)[perm]
        if self.gain_error is not None and np.ndim(self.gain_error):
            self.gain_error = np.asarray(self.gain_error)[perm]
        for band in self.bands:
            idx = band.det_index
            start, stop = int(idx[0]), int(idx[-1] + 1)
            if not np.array_equal(idx, np.arange(start, stop)):
                raise ValueError("permute_detectors requires contiguous band blocks")
            local = perm[start:stop] - start
            if local.min() < 0 or local.max() >= stop - start:
                raise ValueError("perm is not band-stable (rows cross band slices)")

            def take_rows(a):
                return None if a is None else np.asarray(a)[local]

            band.cmb_samples = take_rows(band.cmb_samples)
            band.noise_basis = take_rows(band.noise_basis)
            if band.map_stages:
                band.map_stages = [
                    (table, take_rows(samples), ev)
                    for (table, samples, ev) in band.map_stages
                ]
        self.__post_init__()  # recompute contiguity + invalidate caches

    def _upsample(self, values):
        if self.upsample_ratio is not None:
            return upsample_time_phases(values, self.upsample_ratio, len(self.t_fine), kind="cubic")
        return upsample_time(
            values,
            jnp.asarray(self.t_coarse, dtype=jnp.float32),
            jnp.asarray(self.t_fine, dtype=jnp.float32),
            kind="cubic",
        )

    def _per_band_assemble(self, pieces_by_band_index, fallback_shape):
        """Concatenate contiguous per-band blocks, or scatter as fallback."""
        if self.band_order is not None:
            return jnp.concatenate([pieces_by_band_index[i] for i in self.band_order], axis=0)
        out = jnp.zeros(fallback_shape, dtype=jnp.float32)
        for i, piece in pieces_by_band_index.items():
            out = out.at[self.bands[i].det_index].set(piece)
        return out

    def device_tables(self):
        """The large spectral tables as a device pytree. Passing this as
        a jit ARGUMENT (see `_loadings(tables=...)`) keeps ~8 MB of
        group spectral weights out of the HLO as embedded constants,
        which would slow every compile at AtLAST scale (as the SHT lane
        tables would)."""
        return {
            "screen_W": [
                None if s.W is None else jnp.asarray(s.W) for s in self.screens
            ],
            "group_W": [jnp.asarray(g.W) for g in self.groups],
            "group_beam": [
                None if g.beam is None else jnp.asarray(g.beam) for g in self.groups
            ],
            "noise_basis": [
                None if b.noise_basis is None else jnp.asarray(b.noise_basis)
                for b in self.bands
            ],
            # fused matmul-noise total: pre-scaled correlated basis
            # columns ((n_det, K) — ~9 MB at AtLAST scale, so it rides
            # as an argument like everything else here)
            "noise_corr_cols": (
                jnp.asarray(self._noise_matmul_specs()[1])
                if self.use_noise_matmul() and self._noise_matmul_specs()[1] is not None
                else None
            ),
        }

    def _resolved(self, tables):
        """(screens, groups) with array fields swapped for the traced
        `tables` entries when given."""
        if tables is None:
            return self.screens, self.groups
        import dataclasses

        screens = [
            dataclasses.replace(s, W=w) if w is not None else s
            for s, w in zip(self.screens, tables["screen_W"])
        ]
        groups = [
            dataclasses.replace(g, W=w, beam=b)
            for g, w, b in zip(self.groups, tables["group_W"], tables["group_beam"])
        ]
        return screens, groups

    def _loadings(
        self, key, offsets, bs_az_c, bs_el_c, return_pwv: bool = False, upto: str = None,
        tables=None,
    ):
        """Pure jnp body; returns dict of (n_det, n_t) loadings in pW
        (and optionally the fine-rate zenith-scaled pwv). Gain errors are
        NOT applied here — see total_power_fn / Simulation.run_obs.

        `upto` truncates the pipeline for stage benchmarking:
        "pwv" (pointing + screens + AR + LOS sampling) or "atmosphere"
        (+ bandpass integration and upsampling)."""
        from ..coords.transforms import offsets_to_phi_theta

        key_atm, key_noise, key_gain = jax.random.split(key, 3)

        # detector az/el at the coarse timestep
        pt = offsets_to_phi_theta(offsets[:, None, :], bs_az_c, bs_el_c)
        det_az, det_el = pt[..., 0], pt[..., 1]
        el_clip = jnp.clip(det_el, jnp.radians(5.0), jnp.pi / 2)

        # unit-height LOS projection (x=E, y=N)
        cot_el = 1 / jnp.tan(el_clip)
        px = jnp.sin(det_az) * cot_el
        py = jnp.cos(det_az) * cot_el
        # boresight track for the windowed sampler
        bs_cot = 1 / jnp.tan(jnp.clip(bs_el_c, jnp.radians(5.0), jnp.pi / 2))
        bs_px = jnp.sin(bs_az_c) * bs_cot
        bs_py = jnp.cos(bs_az_c) * bs_cot

        # turbulence screens -> zenith-scaled pwv at the coarse timestep,
        # via the shared sampler (same code Atmosphere.simulate_pwv runs).
        # AR processes extrude inside the program (a lax.scan of MXU
        # matmuls); their covariance operators were factorized at build.
        t_c = jnp.asarray(self.t_coarse, dtype=jnp.float32)
        key_scr, key_ar = jax.random.split(key_atm)
        ar_values, ran = {}, {}
        from ..atmosphere.process import _ar_extrude

        for i, screen in enumerate(self.screens):
            if screen.process is None:
                continue
            p = screen.process
            if id(p) not in ran:
                key_p = jax.random.fold_in(key_ar, len(ran))
                key_init, key_scan = jax.random.split(key_p)
                n_steps = 2 * p.n_extrusion
                buffer_init = jax.random.normal(
                    key_init, (p.n_extrusion + n_steps, p.n_cross_section), dtype=jnp.float32
                )
                buf = _ar_extrude(
                    key_scan, p.A, p.B, buffer_init, p._ext_idx, p._cross_idx, n_steps
                )
                ran[id(p)] = buf[: p.n_extrusion]
            ar_values[i] = ran[id(p)][:, screen.ar_columns].T  # (ny, nx)

        screens, groups = self._resolved(tables)
        pwv = accumulate_pwv(
            key_scr, self.mean_pwv, screens, groups,
            px, py, bs_px, bs_py, t_c, ar_values=ar_values,
        )
        if upto == "pwv":
            return {"pwv": pwv}

        # per-band bandpass-integrated emission at coarse rate, assembled
        # without scatters when bands partition the det axis contiguously
        mueller_I = jnp.asarray(self.mueller_I, dtype=jnp.float32)
        loading_pieces = {}
        for i, band in enumerate(self.bands):
            if band.power_eval is not None:
                p = band.power_eval(pwv[band.det_sel], el_clip[band.det_sel])
            else:
                interp = RegularGridInterpolator((band.pwv_side, band.el_side), band.power_table)
                p = interp((pwv[band.det_sel], el_clip[band.det_sel]))
            loading_pieces[i] = mueller_I[band.det_sel, None] * p.astype(jnp.float32)
        loading_c = self._per_band_assemble(loading_pieces, pwv.shape)
        if upto == "coarse":
            # the streaming executor's whole-observation stage: every
            # coarse-rate field (O(n_det x n_tc)); fine-rate synthesis
            # then proceeds block-by-block at O(block) memory
            return {"loading_c": loading_c, "pwv_c": pwv, "el_c": el_clip}

        # upsample to the TOD rate (phase stencil: no gathers)
        fields = {"atmosphere": self._upsample(loading_c)}
        if upto == "atmosphere":
            return fields

        # fused CMB / input-map stages: the sky timelines are static
        # (pointing is known at build); the (pwv, el)-dependent
        # calibration factors are evaluated in-program at the FINE rate —
        # the fine pwv carries the fast turbulence fluctuations that
        # modulate the transmission (mixin physics, sim/cmb.py:63-100)
        has_cmb = any(b.cmb_samples is not None for b in self.bands)
        has_map = any(b.map_stages for b in self.bands)
        if has_cmb or has_map:
            if self.upsample_ratio is not None:
                pwv_f = upsample_time_phases(pwv, self.upsample_ratio, len(self.t_fine), kind="linear")
                el_f = upsample_time_phases(el_clip, self.upsample_ratio, len(self.t_fine), kind="cubic")
            else:
                t_f = jnp.asarray(self.t_fine, dtype=jnp.float32)
                pwv_f = upsample_time(pwv, t_c, t_f, kind="linear")
                el_f = upsample_time(el_clip, t_c, t_f, kind="cubic")

        if has_cmb:
            cmb_pieces = {}
            for i, band in enumerate(self.bands):
                idx = band.det_sel
                xi = (pwv_f[idx], el_f[idx])
                if band.cmb_P0_eval is not None:
                    P0 = band.cmb_P0_eval(*xi)
                    dPdT = band.cmb_dPdT_eval(*xi)
                else:
                    P0 = RegularGridInterpolator(
                        (band.pwv_side, band.el_side), jnp.asarray(band.cmb_P0_table)
                    )(xi)
                    dPdT = RegularGridInterpolator(
                        (band.pwv_side, band.el_side), jnp.asarray(band.cmb_dPdT_table)
                    )(xi)
                cmb_pieces[i] = (
                    P0.astype(jnp.float32) * mueller_I[idx, None]
                    + dPdT.astype(jnp.float32) * jnp.asarray(band.cmb_samples)
                )
            fields["cmb"] = self._per_band_assemble(
                cmb_pieces, (len(self.offsets), len(self.t_fine))
            )

        if has_map:
            map_pieces = {}
            for i, band in enumerate(self.bands):
                idx = band.det_sel
                piece = jnp.zeros((len(band.det_index), len(self.t_fine)), dtype=jnp.float32)
                for table, samples, cal_eval in band.map_stages or []:
                    if cal_eval is not None:
                        cal = cal_eval(pwv_f[idx], el_f[idx])
                    else:
                        cal = RegularGridInterpolator(
                            (band.pwv_side, band.el_side), jnp.asarray(table)
                        )((pwv_f[idx], el_f[idx]))
                    piece = piece + cal.astype(jnp.float32) * jnp.asarray(samples)
                map_pieces[i] = piece
            map_field = self._per_band_assemble(
                map_pieces, (len(self.offsets), len(self.t_fine))
            )
            # triangular continuous-integration kernel AFTER calibration
            # (mixin order; one shared implementation)
            from ..sim.map import apply_integration_kernel

            fields["map"] = apply_integration_kernel(map_field)

        if upto == "signal":
            # every non-noise field: the fused matmul-noise total path
            # (total_power_fn) synthesizes noise + gains + accumulate in
            # one MXU contraction from these
            return fields

        if self.with_noise:
            n_det, n_t = len(self.offsets), len(self.t_fine)
            noise_pieces = {}
            for i, band in enumerate(self.bands):
                # stable per-band stream: fold in the band's position in
                # the (config-ordered) band list, NOT a salted str hash —
                # the same seed must give the same noise across processes
                band_key = jax.random.fold_in(key_noise, i)
                basis = band.noise_basis
                if tables is not None and tables["noise_basis"][i] is not None:
                    basis = tables["noise_basis"][i]
                unscaled = generate_noise_with_knee(
                    band_key,
                    shape=(len(band.det_index), n_t),
                    sample_rate=self.sample_rate,
                    knee=band.knee,
                    basis=basis,
                    corr_prop=band.corr_prop,
                )
                # photon-loading term: total NEP = NEP + NEP_per_loading * P
                # with P the time-resolved non-noise loading in W
                # (reference maria/sim/noise.py:33)
                if band.NEP_per_loading:
                    loading_W = 1e-12 * sum(v[band.det_sel] for v in fields.values())
                    total_NEP = band.NEP + band.NEP_per_loading * loading_W
                else:
                    total_NEP = band.NEP
                noise_pieces[i] = 1e12 * total_NEP * unscaled
            fields["noise"] = self._per_band_assemble(noise_pieces, (n_det, n_t))

        if return_pwv:
            if has_cmb or has_map:
                pwv_fine = pwv_f  # already computed for the calibration factors
            elif self.upsample_ratio is not None:
                pwv_fine = upsample_time_phases(pwv, self.upsample_ratio, len(self.t_fine), kind="linear")
            else:
                t_f = jnp.asarray(self.t_fine, dtype=jnp.float32)
                pwv_fine = upsample_time(pwv, t_c, t_f, kind="linear")
            return fields, pwv_fine
        return fields

    def draw_gains(self, key):
        """Multiplicative gain errors for one realization, (n_det, 1) —
        or 1.0 when the program carries none. Derived from `key`'s THIRD
        stream so it never collides with the atmosphere/noise streams
        (split(key)[1] == split(key, 3)[1]). The single source for both
        the batch path and the streaming executor's carried state."""
        if self.gain_error is None:
            return 1.0
        key_gain = jax.random.split(key, 3)[2]
        return jnp.exp(
            jnp.asarray(self.gain_error, dtype=jnp.float32)
            * jax.random.normal(key_gain, (len(self.offsets),))
        )[:, None]

    def use_noise_matmul(self) -> bool:
        """Whether total_power_fn fuses the noise stage into one
        matmul (noise/dft.py). Default: where the platform table takes
        it (the `noise_total_matmul` gate of maria_tpu/backend.py), when
        the bands partition the detector axis contiguously and no band
        carries the
        time-resolved NEP_per_loading term (that scale depends on the
        signal sample-wise and cannot fold into the matmul columns).
        Override with MARIA_TPU_NOISE_TOTAL=matmul|fields."""
        import os

        mode = os.environ.get("MARIA_TPU_NOISE_TOTAL", "").lower()
        if mode in ("fields", "0", "off"):
            return False
        structural = (
            self.with_noise
            and self.band_order is not None
            and len(self.bands) > 0
            and all(not b.NEP_per_loading for b in self.bands)
            and len(self.t_fine) > 1
        )
        if mode in ("matmul", "1", "on"):
            return structural
        from ..backend import use

        return structural and use("noise_total_matmul")

    def _noise_matmul_specs(self):
        """(specs, corr_cols, n_fft) for noise/dft.noise_total_matmul —
        static per program (host numpy, memoized), assembled in
        band_order so the spec slices walk the detector axis
        contiguously."""
        cached = getattr(self, "_noise_specs_cache", None)
        if cached is not None:
            return cached
        from ..atmosphere.fourier import good_fft_size
        from ..noise.dft import NoiseBandSpec, band_half_spectrum

        n = len(self.t_fine)
        n_fft = good_fft_size(n)
        specs = []
        shapes = []
        col_blocks = []
        k_total = 0
        for i in self.band_order:
            b = self.bands[i]
            start, stop = int(b.det_index[0]), int(b.det_index[-1] + 1)
            cp = b.corr_prop if b.noise_basis is not None else 0.0
            shape = band_half_spectrum(self.sample_rate, b.knee, 1.0, n_fft,
                                       corr_prop=cp)
            shapes.append(shape)
            k_modes = 0
            mode_c = None
            if cp > 0:
                k_modes = int(np.asarray(b.noise_basis).shape[-1])
                mode_c = band_half_spectrum(self.sample_rate, b.knee, 1.0, n_fft,
                                            pink_only=True)
                col_blocks.append((start, stop, k_total, b.NEP,
                                   np.sqrt(cp) * np.asarray(b.noise_basis)))
                k_total += k_modes
            specs.append(NoiseBandSpec(start=start, stop=stop, c=1e12 * b.NEP * shape,
                                       k_modes=k_modes, mode_c=mode_c,
                                       key_index=i))
        # one normalized spectral shape across bands (same knee/cp/rate,
        # e.g. all AtLAST bands) -> single whole-axis draw + per-det NEP
        # row scale in the matmul epilogue (noise/dft.py shared-shape path)
        shared = all(np.allclose(s, shapes[0], rtol=1e-6) for s in shapes[1:])
        shared_c = shapes[0] if shared else None
        row_scale = None
        if shared:
            row_scale = np.zeros((len(self.offsets), 1), np.float32)
            for i, sp in zip(self.band_order, specs):
                row_scale[sp.start:sp.stop] = 1e12 * self.bands[i].NEP
        corr_cols = None
        if k_total:
            corr_cols = np.zeros((len(self.offsets), k_total), np.float32)
            for start, stop, col0, nep, block in col_blocks:
                # shared mode: NEP rides the epilogue row scale instead
                scale = 1.0 if shared else 1e12 * nep
                corr_cols[start:stop, col0:col0 + block.shape[-1]] = scale * block
        self._noise_specs_cache = (specs, corr_cols, n_fft, shared_c, row_scale)
        return self._noise_specs_cache

    def total_power_fn(self):
        """(key, offsets, bs_az_c, bs_el_c) -> (n_det, n_t) total pW,
        including multiplicative gain errors.

        Where the platform table takes it (see use_noise_matmul) the
        noise stage runs as ONE matmul whose epilogue fuses the
        `signal * gains +` accumulate —
        same process as the per-band path, different realization for
        the same key (noise/dft.py docstring)."""
        if self.use_noise_matmul():
            from ..noise.dft import noise_total_matmul

            specs, corr_cols, n_fft, shared_c, row_scale = self._noise_matmul_specs()

            def fn(key, offsets, bs_az_c, bs_el_c, tables=None):
                fields = self._loadings(key, offsets, bs_az_c, bs_el_c,
                                        upto="signal", tables=tables)
                gains = self.draw_gains(key)
                A = gains * sum(fields.values())
                key_noise = jax.random.split(key, 3)[1]
                cols = corr_cols
                if tables is not None and tables.get("noise_corr_cols") is not None:
                    cols = tables["noise_corr_cols"]
                return noise_total_matmul(
                    key_noise, A, specs, n=len(self.t_fine), n_fft=n_fft,
                    corr_cols=cols, shared_c=shared_c, row_scale=row_scale,
                )

            return fn

        def fn(key, offsets, bs_az_c, bs_el_c, tables=None):
            fields = self._loadings(key, offsets, bs_az_c, bs_el_c, tables=tables)
            gains = self.draw_gains(key)
            total = 0.0
            for name, v in fields.items():
                total = total + (v if name == "noise" else v * gains)
            return total

        return fn

    def fields_fn(self):
        """(key, offsets, bs_az_c, bs_el_c) -> (fields dict, pwv_fine)."""
        return partial(self._loadings, return_pwv=True)

    def example_args(self, key=None):
        key = key if key is not None else jax.random.key(0)
        return (
            key,
            jnp.asarray(self.offsets, dtype=jnp.float32),
            jnp.asarray(self.bs_az_coarse, dtype=jnp.float32),
            jnp.asarray(self.bs_el_coarse, dtype=jnp.float32),
        )


def _crop_table(x_side, y_side, table, x_lo, x_hi, y_lo, y_hi):
    """Restrict a (x, y) -> value table to the REACHABLE window (one
    guard cell beyond each bound). Bilinear interpolation is local, so
    values inside the window are IDENTICAL to the full table's; the
    gather-free evaluator's cost is ~2 nx ny VPU ops per sample, and a
    realization's pwv spans a few cells of the 24-point axis (mean
    +- 8 sigma of the screen rms), so cropping cuts the dominant
    coarse-stage VPU cost several-fold. Samples beyond the window
    (astronomically rare, > 8 sigma) clamp to the window edge."""
    x = np.asarray(x_side)
    y = np.asarray(y_side)
    i0 = max(int(np.searchsorted(x, x_lo)) - 1, 0)
    i1 = min(int(np.searchsorted(x, x_hi)) + 1, len(x))
    j0 = max(int(np.searchsorted(y, y_lo)) - 1, 0)
    j1 = min(int(np.searchsorted(y, y_hi)) + 1, len(y))
    i1 = max(i1, i0 + 2)
    j1 = max(j1, j0 + 2)
    i0 = min(i0, len(x) - 2)
    j0 = min(j0, len(y) - 2)
    return x[i0:i1], y[j0:j1], np.asarray(table)[i0:i1, j0:j1]


def build_tod_program(
    obs,
    with_noise: bool = True,
    noise_kwargs: dict = {},
    cmb=None,
    input_map=None,
    map_kwargs: dict = {},
) -> TODProgram:
    """Assemble the fused program from an initialized Observation.

    With `cmb` (a CMB HEALPixMap in K_CMB) and/or `input_map` (a Map),
    the corresponding stages run inside the same jit program: their sky
    timelines are precomputed here (pointing is static per observation,
    reference sim/cmb.py:115-118), while the pwv/el-dependent
    calibration factors are evaluated per realization in-program."""
    from ..sim.cmb import cmb_power_tables
    from ..sim.map import map_transmission_table, static_map_samples
    from ..tod.tod import Pointing
    from ..utils import compute_diameter, generate_spatial_basis
    from .interp import make_table_eval

    atm = obs.atmosphere
    T_base = float(atm.weather.temperature[0])
    t0 = float(obs.t[0])
    stokes_weight = np.asarray(obs.instrument.dets.stokes_weight(), dtype=np.float32)

    # reachable (pwv, el) window for the table evaluators (_crop_table):
    # pwv = weather mean +- 8 sigma of the summed screen rms (pairs of a
    # band-split screen double-count their shared rms — a safe
    # overestimate); el = the boresight track +- the array extent,
    # clipped like the program clips
    sigma_pwv = float(np.sqrt(
        sum(float(s.pwv_rms) ** 2 for s in atm.screens)
        + sum(float(np.sum(np.asarray(g.pwv_rms) ** 2))
              for g in getattr(atm, "groups", []))
    ))
    mean_pwv = float(atm.weather.pwv)
    pwv_lo = max(0.0, mean_pwv - 8 * sigma_pwv)
    pwv_hi = mean_pwv + 8 * sigma_pwv
    bs_el = np.asarray(atm.boresight.el, dtype=np.float64)
    off_max = float(np.abs(np.asarray(obs.offsets)).max()) if len(obs.offsets) else 0.0
    el_lo = max(np.radians(5.0), float(bs_el.min()) - 2 * off_max)
    el_hi = min(np.pi / 2, float(bs_el.max()) + 2 * off_max)

    def cropped_eval(pwv_side, el_side, table):
        xs, ys, tab = _crop_table(np.asarray(pwv_side), np.asarray(el_side),
                                  np.asarray(table), pwv_lo, pwv_hi, el_lo, el_hi)
        return make_table_eval(xs, ys, tab)

    bands = []
    for band in obs.instrument.dets.bands:
        det_index = np.where(obs.instrument.dets.band_name == band.name)[0]
        pwv_side, el_side, table = band.atmosphere_power_table(atm.spectrum, T_base)
        power_eval = cropped_eval(pwv_side, el_side, table)

        cmb_samples = cmb_P0 = cmb_dPdT = None
        cmb_P0_eval = cmb_dPdT_eval = None
        if cmb is not None:
            pointing = Pointing(obs.boresight, obs.offsets[det_index], obs.q)
            cmb_samples = np.asarray(
                cmb.sample_stokes(pointing, jnp.asarray(stokes_weight[det_index])),
                dtype=np.float32,
            )
            _, _, cmb_P0, cmb_dPdT = cmb_power_tables(band, atm.spectrum, T_base)
            cmb_P0_eval = cropped_eval(pwv_side, el_side, cmb_P0)
            cmb_dPdT_eval = cropped_eval(pwv_side, el_side, cmb_dPdT)

        map_stages = None
        if input_map is not None:
            bilinear = map_kwargs.get("bilinear_sampling", True)
            map_stages = []
            for channel, samples in static_map_samples(
                input_map, band, det_index, obs, bilinear=bilinear
            ):
                tab = map_transmission_table(band, input_map, channel, atm.spectrum, T_base)
                cal_eval = cropped_eval(pwv_side, el_side, tab)
                map_stages.append((tab, samples, cal_eval))
        basis, corr_prop = None, 0.0
        cp = noise_kwargs.get("correlated_noise_proportion", 0.0)
        band_offsets = obs.instrument.dets.offsets[det_index]
        fov = compute_diameter(band_offsets)
        if with_noise and cp > 0 and fov > 0 and len(det_index) > 16:
            basis = generate_spatial_basis(
                offsets=band_offsets, k=5, n_side=16,
                scale=fov * noise_kwargs.get("correlated_noise_spatial_scale", 1.0),
            )
            corr_prop = cp
        bands.append(
            BandBlock(
                name=band.name, det_index=det_index,
                pwv_side=pwv_side, el_side=el_side, power_table=table,
                NEP=band.NEP, knee=band.knee, noise_basis=basis, corr_prop=corr_prop,
                NEP_per_loading=band.NEP_per_loading,
                cmb_samples=cmb_samples, cmb_P0_table=cmb_P0, cmb_dPdT_table=cmb_dPdT,
                map_stages=map_stages,
                power_eval=power_eval, cmb_P0_eval=cmb_P0_eval,
                cmb_dPdT_eval=cmb_dPdT_eval,
            )
        )

    # AR processes need their covariance operators factorized (host,
    # float64) before the program can run their extrusion scans on device
    for s in atm.screens:
        if s.process is not None and not s.process._computed:
            s.process.run_setup()

    return TODProgram(
        screens=list(atm.screens),
        groups=list(getattr(atm, "groups", [])),
        mean_pwv=float(atm.weather.pwv),
        t_coarse=np.asarray(atm.boresight.t, dtype=np.float64) - t0,
        t_fine=np.asarray(obs.t, dtype=np.float64) - t0,
        offsets=np.asarray(obs.offsets, dtype=np.float32),
        bs_az_coarse=np.asarray(atm.boresight.az, dtype=np.float32),
        bs_el_coarse=np.asarray(atm.boresight.el, dtype=np.float32),
        mueller_I=obs.instrument.dets.mueller()[:, 0, 0],
        bands=bands,
        sample_rate=obs.sample_rate,
        with_noise=with_noise,
        gain_error=np.asarray(obs.instrument.dets.gain_error, dtype=np.float32),
    )
