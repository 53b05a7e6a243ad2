"""Maximum-likelihood map-making
(reference: maria/mappers/ml_mapper.py:29-535, which uses torch sparse
matrices, FFT noise weighting, low-rank detector modes with Woodbury
terms, and gradient-descent / hand-rolled CG solvers).

On-device redesign:
- the solution is per-Stokes and per-frequency-channel: m has shape
  (n_stokes, n_nu, n_pix+1); the pointing matrix is a Mueller-weighted
  gather (P m = sum_s w_s * m[s, c_d, pix]) and its transpose a
  segment-sum over channel-offset pixel ids — no sparse matrices;
- the noise covariance is diagonal in frequency per detector (smoothed
  PSD of map-subtracted residuals, Tukey-windowed), optionally plus
  k low-rank detector modes N_f = diag(A_f) + U diag(lambda_k(f)) U^T,
  inverted EXACTLY per frequency with the Woodbury identity (the
  reference collapses the k x k correction over frequency,
  ml_mapper.py:282-286); the k x k factors are precomputed per epoch;
- solvers: conjugate gradients (jax.scipy.sparse.linalg.cg) and a
  steepest-descent solver with exact line search on the quadratic
  objective (the reference's autograd GD loop, ml_mapper.py:379-485).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import scipy as sp

from ..coords.transforms import phi_theta_to_offsets_jit
from .base import BaseProjectionMapper

logger = logging.getLogger("maria_tpu")


def _tukey(n, alpha=0.25):
    return jnp.asarray(sp.signal.windows.tukey(n, alpha), dtype=jnp.float32)


def _smooth_spectrum(spec, k):
    if k <= 1:
        return spec
    kernel = jnp.ones(k) / k
    return jnp.apply_along_axis(lambda s: jnp.convolve(s, kernel, mode="same"), -1, spec)


class MaximumLikelihoodMapper(BaseProjectionMapper):
    def __init__(
        self,
        *args,
        n_epochs: int = 2,
        n_cg_iters: int = 50,
        spectrum_smoothing: float = 8.0,
        k: int = 0,
        init: str = "bin",
        bilinear: bool = False,
        prior: bool = False,
        mesh=None,
        mxu_pointing: bool = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.n_epochs = n_epochs
        self.n_cg_iters = n_cg_iters
        self.spectrum_smoothing = spectrum_smoothing
        self.k = k
        # multi-chip: shard every per-TOD block over the mesh's "det"
        # axis (detectors are independent through P, N^-1 and the FFTs;
        # the segment-sums and Woodbury contractions psum via XLA's
        # sharding propagation). Detector counts are padded with
        # zero-weight rows to the shard count, so any n_det works.
        self.mesh = mesh
        self._det_shards = (
            dict(zip(mesh.axis_names, mesh.devices.shape)).get("det", 1) if mesh else 1
        )
        if init not in ("bin", "random"):
            raise ValueError(f"init must be 'bin' or 'random', not '{init}'.")
        self.init = init
        if bilinear:
            logger.warning("bilinear=True: the ML mapper samples nearest-pixel; ignoring.")
        if prior:
            logger.warning("prior=True: no prior term is implemented; ignoring.")
        # per-epoch noise-model diagnostics (reference ml_mapper.py keeps
        # per-epoch noise-model plots); each entry is a list of per-TOD
        # dicts {f, median_psd, mode_psd}
        self.noise_model_history = []
        self._epoch_k0_jit = None  # built lazily on the first fused fit()
        self._mxu_pointing = mxu_pointing
        self._prepare()
        self._compute_naive_map()
        # `.map` is inspectable before fit(): the binned (or random)
        # starting map (reference docs tutorials/mustang-nebula.ipynb
        # plot mapper.map before fitting)
        self.map = self._grid_to_map(self.naive_map, self.hits)

    def _prepare(self):
        """Per-TOD blocks: channel-offset pixel ids, Stokes weights, data."""
        self.n_pix = self.n_x * self.n_y
        self.n_pix1 = self.n_pix + 1  # + overflow bucket
        self.n_s = len(self.stokes)
        self.n_nu = len(self.nu)
        # the time-bin axis extends the channel axis: map id
        # ((chan * t_bins) + t_bin) * n_pix1 + pix, so time-binned maps
        # get an independent ML solve per bin (the reference's base grid
        # is (stokes, nu, t, y, x), mappers/base.py:68-78)
        self.n_cpix = self.n_nu * self.t_bins * self.n_pix1
        self.n_m = self.n_s * self.n_cpix

        # built EAGERLY: creating it lazily inside a traced caller (cg's
        # custom_linear_solve) would cache an escaping tracer
        mask = np.ones(self.n_m, dtype=np.float32)
        mask.reshape(self.n_s, self.n_nu, self.t_bins, self.n_pix1)[..., -1] = 0.0
        self._overflow_mask_cached = jnp.asarray(mask)

        stokes_cols = ["IQUV".index(s) for s in self.stokes]
        band_channel = {b.name: i for i, b in enumerate(self.bands)}

        self.blocks = []
        self._block_aux = []  # host-side per-block (chan, tbin) ids
        x0 = -(self.n_x - 1) / 2 * self.res
        y0 = -(self.n_y - 1) / 2 * self.res
        for tod in self.tods:
            pointing = tod.pointing
            if self.frame.name == "ra/dec":
                ra, dec = pointing.det_radec()
                pt = jnp.stack([ra, dec], axis=-1)
            else:
                az, el = pointing.det_azel()
                pt = jnp.stack([az, el], axis=-1)
            offsets = phi_theta_to_offsets_jit(pt, self.center[0], self.center[1])
            ix = jnp.round((offsets[..., 0] - x0) / self.res).astype(jnp.int32)
            iy = jnp.round((offsets[..., 1] - y0) / self.res).astype(jnp.int32)
            inside = (ix >= 0) & (ix < self.n_x) & (iy >= 0) & (iy < self.n_y)
            pix = jnp.where(
                inside, jnp.clip(iy, 0, self.n_y - 1) * self.n_x + jnp.clip(ix, 0, self.n_x - 1),
                self.n_pix,  # overflow bucket
            )
            # channel/time-offset ids: pixel p of channel c in time bin t
            # lives at (c*t_bins + t)*n_pix1 + p
            chan = np.array([band_channel[b] for b in tod.dets.band_name], dtype=np.int32)
            tbin = np.clip(
                np.digitize(np.asarray(tod.time), self.t_edges) - 1, 0, self.t_bins - 1
            ).astype(np.int32)
            pix_chan = pix + jnp.asarray(
                (chan[:, None] * self.t_bins + tbin[None, :]) * self.n_pix1
            )
            # per-detector Stokes weights (n_det, n_s) from the Mueller rows
            sw = np.asarray(tod.dets.stokes_weight(), dtype=np.float32)[:, stokes_cols]
            data = jnp.asarray(tod.signal, dtype=jnp.float32)
            n_real_rows = data.shape[0]  # rows past this are zero-weight padding
            pad = -data.shape[0] % self._det_shards
            if pad:
                # zero-weight rows: pix -> an overflow bucket, sw -> 0,
                # data -> 0; they contribute nothing anywhere
                pix_chan = jnp.pad(pix_chan, ((0, pad), (0, 0)), constant_values=self.n_pix)
                sw = np.pad(sw, ((0, pad), (0, 0)))
                data = jnp.pad(data, ((0, pad), (0, 0)))
            self.blocks.append(
                {
                    "pix": self._put_det(pix_chan),
                    "sw": self._put_det(jnp.asarray(sw)),
                    "data": self._put_det(data),
                    "fs": tod.fs,
                    "n_real": n_real_rows,
                }
            )
            self._block_aux.append(
                {"chan": np.pad(chan, (0, pad), constant_values=-1) if pad else chan,
                 "tbin": tbin}
            )
        self._setup_mxu_pointing()

    def _put_det(self, x):
        """Shard a det-major array over the mesh (no-op without one)."""
        if self.mesh is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(x, NamedSharding(self.mesh, P("det", *[None] * (x.ndim - 1))))

    def _setup_mxu_pointing(self):
        """Static geometry for a blocked P^T: the pixel ids never change
        across CG iterations, so ONE blocked plan per TOD (ops/binning
        make_blocked_bin_plan_on_device) replaces the per-iteration
        segment-sums. Channel-stacked data shares the hats across every
        (stokes, channel, time-bin) frame; the overflow bucket is a
        dense masked sum. Auto-enabled where the platform table takes it
        (the `ml_blocked_pointing` gate of maria_tpu/backend.py), with
        no mesh and few frames (mxu_pointing= overrides; det-sharded
        gathers would cross shards)."""
        forced = self._mxu_pointing
        if forced is None:
            from ..backend import use

            enabled = (
                use("ml_blocked_pointing") and self.mesh is None
                and self.n_s * self.n_nu * self.t_bins <= 8
            )
        else:
            enabled = forced
            if enabled and self.mesh is not None:
                raise ValueError("mxu_pointing=True is incompatible with mesh= (det-sharded runs use segment-sums).")
        if not enabled:
            self._mxu_pointing = False
            return
        from ..ops.binning import make_blocked_bin_plan_on_device
        from ..ops.binning_runs import make_runchunk_bin_plan_on_device

        for block, aux in zip(self.blocks, self._block_aux):
            within = block["pix"] % self.n_pix1
            ovf = within == self.n_pix
            iy = jnp.where(ovf, -1, within // self.n_x)
            ix = jnp.where(ovf, -1, within % self.n_x)
            # run-compressed plan first (3-4x fewer one-hot rows per CG
            # step); blocked fallback for fast scans
            import os

            rplan = (
                make_runchunk_bin_plan_on_device(iy, ix, self.n_y, self.n_x)
                if os.environ.get("MARIA_TPU_ML_RUNBIN", "1") != "0"
                else None
            )
            if rplan is not None:
                block["rmeta"] = rplan
                block["re"] = rplan.e_idx
                block["rly"], block["rlx"] = rplan.run_ly, rplan.run_lx
                block["rorig"] = jnp.asarray(rplan.origins)
                block["rorder"] = jnp.asarray(rplan.order)
                block["rwcnt"] = jnp.asarray(rplan.wcnt)
                plan = rplan
            else:
                plan = make_blocked_bin_plan_on_device(iy, ix, self.n_y, self.n_x)
            if plan is None:  # windows would span most of the map
                if forced:
                    raise ValueError(
                        "mxu_pointing=True but blocked windows would span most of the "
                        "map for this scan/map geometry — use mxu_pointing=False."
                    )
                self._mxu_pointing = False
                return
            if rplan is None:
                block["bly"], block["blx"] = plan.ly, plan.lx
                block["borig"] = jnp.asarray(plan.origins)
                block["border"] = jnp.asarray(plan.order)
            # overflow-bucket mask — None when nothing ever overflows,
            # so the per-iteration dense reduction is skipped entirely
            block["ovf"] = ovf.astype(jnp.float32) if bool(ovf.any()) else None
            if rplan is None:
                block["bmeta"] = plan  # static shapes only (arrays passed explicitly)
            # frame masks: detector -> channel (static), sample -> t bin
            block["cmask"] = (
                jnp.asarray((aux["chan"][None, :] == np.arange(self.n_nu)[:, None]),
                            dtype=jnp.float32) if self.n_nu > 1 else None
            )
            block["tmask"] = (
                jnp.asarray((aux["tbin"][None, :] == np.arange(self.t_bins)[:, None]),
                            dtype=jnp.float32) if self.t_bins > 1 else None
            )
        self._mxu_pointing = True

    def _project_T_mxu(self, v, block):
        """P^T v via one channel-stacked MXU hat contraction (exact same
        segments as the scatter path; f32 accumulation order differs)."""
        from ..ops.binning import bin_blocked

        chans = []
        for s in range(self.n_s):
            vs = block["sw"][:, s, None] * v
            for c in range(self.n_nu):
                vc = vs * block["cmask"][c][:, None] if block["cmask"] is not None else vs
                for t in range(self.t_bins):
                    chans.append(vc * block["tmask"][t] if block["tmask"] is not None else vc)
        data = jnp.stack(chans)  # (n_s * n_nu * t_bins, n_det, n_t)
        if "rmeta" in block:
            from ..ops.binning_runs import bin_runchunk

            # hilo: the CG operand is noise-filtered and fluctuates at
            # the signal scale, outside the one-pass shifted bound
            maps = bin_runchunk(
                data, block["rmeta"], e_idx=block["re"], run_ly=block["rly"],
                run_lx=block["rlx"], origins=block["rorig"], order=block["rorder"],
                wcnt=block["rwcnt"], precision="hilo",
            ).reshape(len(chans), self.n_pix)
        else:
            maps = bin_blocked(
                data, block["bmeta"], ly=block["bly"], lx=block["blx"],
                origins=block["borig"], order=block["border"],
            ).reshape(len(chans), self.n_pix)
        if block.get("ovf") is not None:  # overflow bucket sums
            # HIGHEST here and in the overflow reads of _project_mxu:
            # a default-precision f32 dot may round the data to TF32
            ovf = jnp.einsum("fdt,dt->f", data, block["ovf"],
                             precision=jax.lax.Precision.HIGHEST)[:, None]
        else:
            ovf = jnp.zeros((len(chans), 1), dtype=maps.dtype)
        out = jnp.concatenate([maps, ovf], axis=-1)  # (n_frames, n_pix1)
        return out.reshape(-1)

    # -- pointing ------------------------------------------------------------------
    def _project_mxu(self, m_flat, block):
        """P m through the run plan's contractions
        (ops/binning_runs.project_runchunk): the static runs make P two
        hat matmuls plus a fused run->sample expansion instead of an
        elementwise pixel gather. Each (det, t) sample reads
        its own (channel, t-bin) frame via the static cmask/tmask;
        overflow samples read their frame's bucket value exactly."""
        from ..ops.binning_runs import project_runchunk

        plan = block["rmeta"]
        m = m_flat.reshape(self.n_s, self.n_nu, self.t_bins, self.n_pix1)
        frames = m[..., : self.n_pix].reshape(-1, self.n_y, self.n_x)
        samp = project_runchunk(
            frames, plan, e_idx=block["re"], run_ly=block["rly"],
            run_lx=block["rlx"], origins=block["rorig"],
        )  # (n_fr, n_det, n_t)
        n_det, n_t = block["data"].shape
        samp = samp.reshape(self.n_s, self.n_nu, self.t_bins, n_det, n_t)
        out = jnp.zeros((n_det, n_t), jnp.float32)
        for s in range(self.n_s):
            acc = jnp.zeros((n_det, n_t), jnp.float32)
            for c in range(self.n_nu):
                for t in range(self.t_bins):
                    x = samp[s, c, t]
                    if block["cmask"] is not None:
                        x = x * block["cmask"][c][:, None]
                    if block["tmask"] is not None:
                        x = x * block["tmask"][t]
                    acc = acc + x
            if block.get("ovf") is not None:
                # overflow samples gather m[s, c_d, t_bin, n_pix]
                ovf_val = m[s, :, :, self.n_pix]  # (n_nu, t_bins)
                if block["cmask"] is not None:
                    per_det = jnp.matmul(block["cmask"].T, ovf_val,  # (n_det, t_bins)
                                         precision=jax.lax.Precision.HIGHEST)
                else:
                    per_det = jnp.broadcast_to(ovf_val[0], (n_det, self.t_bins))
                if block["tmask"] is not None:
                    field = jnp.einsum("dk,kt->dt", per_det, block["tmask"],
                                       precision=jax.lax.Precision.HIGHEST)
                else:
                    field = jnp.broadcast_to(per_det[:, :1], (n_det, n_t))
                acc = acc + block["ovf"] * field
            out = out + block["sw"][:, s, None] * acc
        return out

    def _project(self, m_flat, block):
        """P m: (n_det, n_t) Mueller-weighted gather per Stokes (or the
        run-plan MXU path when the static plan exists)."""
        if self._mxu_pointing and "rmeta" in block:
            return self._project_mxu(m_flat, block)
        m = m_flat.reshape(self.n_s, self.n_cpix)
        out = 0.0
        for s in range(self.n_s):
            out = out + block["sw"][:, s, None] * jnp.take(m[s], block["pix"], axis=0)
        return out

    def _project_T(self, v, block):
        """P^T v: Stokes-weighted segment-sum over channel-offset pixels
        (or the MXU hat contraction when the static plan exists)."""
        if self._mxu_pointing and ("bly" in block or "rmeta" in block):
            return self._project_T_mxu(v, block)
        parts = []
        for s in range(self.n_s):
            parts.append(
                jax.ops.segment_sum(
                    (block["sw"][:, s, None] * v).ravel(),
                    block["pix"].ravel(),
                    num_segments=self.n_cpix,
                )
            )
        return jnp.concatenate(parts)

    # -- noise model -------------------------------------------------------------
    def _update_noise_model(self, m_flat):
        """Per-detector inverse PSD (+ optional low-rank detector modes)
        from map-subtracted residuals (reference ml_mapper.py:192-299)."""
        from ..utils.signal import decompose

        epoch_diag = []
        for block in self.blocks:
            d = block["data"]
            resid = d - self._project(m_flat, block)
            resid = resid - resid.mean(axis=-1, keepdims=True)
            n = resid.shape[-1]
            win = _tukey(n)
            wd = resid * win

            if self.k > 0 and d.shape[0] > self.k:
                # top-k detector modes of the windowed residuals
                a, b = decompose(np.asarray(wd), k=self.k)
                U = self._put_det(jnp.asarray(a, dtype=jnp.float32))  # (n_det, k)
                modes = jnp.asarray(b, dtype=jnp.float32)  # (k, n_t)
                noise = wd - U @ modes
                lam = jnp.abs(jnp.fft.rfft(modes, axis=-1)) ** 2 / (win**2).sum()
                lam = jnp.clip(_smooth_spectrum(lam, int(self.spectrum_smoothing)), 1e-30, None)
            else:
                U, lam, noise = None, None, wd

            spec = jnp.abs(jnp.fft.rfft(noise, axis=-1)) ** 2 / (win**2).sum()
            spec = _smooth_spectrum(spec, int(self.spectrum_smoothing))
            A_inv = 1.0 / jnp.clip(spec, 1e-30, None)
            block["A_inv"] = A_inv

            if U is not None:
                # per-frequency Woodbury core: (diag(1/lam_f) + U^T A_f^-1 U)^-1
                G = jnp.einsum("df,dk,dl->fkl", A_inv, U, U)  # (n_f, k, k)
                D = jax.vmap(jnp.diag, in_axes=1)(1.0 / lam)  # (n_f, k, k)
                block["U"] = U
                block["core"] = jnp.linalg.inv(D + G)  # (n_f, k, k)
            else:
                block["U"] = None

            epoch_diag.append(
                {
                    "f": np.fft.rfftfreq(n, d=1 / block["fs"]),
                    # median on device over REAL rows (zero-weight padding
                    # rows have zero spectra): only the n_f-length result
                    # crosses to the host, not the (n_det, n_f) PSD matrix
                    "median_psd": np.asarray(jnp.median(spec[: block["n_real"]], axis=0)),
                    "mode_psd": np.asarray(lam) if lam is not None else None,
                }
            )
        self.noise_model_history.append(epoch_diag)

    def _apply_inverse_N(self, block, v):
        """N^-1 v with N_f = diag(A_f) + U diag(lam_f) U^T, exact per
        frequency via Woodbury (reference ml_mapper.py:301-327)."""
        n = v.shape[-1]
        fv = jnp.fft.rfft(v, axis=-1)
        x = block["A_inv"] * fv
        if block.get("U") is not None:
            U = block["U"]
            y = jnp.einsum("dk,df->kf", U, x)  # U^T A^-1 fv
            z = jnp.einsum("fkl,lf->kf", block["core"].astype(y.dtype), y)
            x = x - block["A_inv"] * jnp.einsum("dk,kf->df", U, z)
        return jnp.fft.irfft(x, n=n, axis=-1)

    # -- normal equations ----------------------------------------------------------
    def _rhs(self, blocks=None):
        rhs = jnp.zeros(self.n_m, dtype=jnp.float32)
        for block in blocks if blocks is not None else self.blocks:
            rhs = rhs + self._project_T(self._apply_inverse_N(block, block["data"]), block)
        return rhs

    def _overflow_mask(self):
        return self._overflow_mask_cached

    def _apply_PNP(self, m_flat, blocks=None):
        out = jnp.zeros(self.n_m, dtype=jnp.float32)
        for block in blocks if blocks is not None else self.blocks:
            Pm = self._project(m_flat, block)
            out = out + self._project_T(self._apply_inverse_N(block, Pm), block)
        # keep the overflow buckets decoupled (identity rows)
        mask = self._overflow_mask()
        return out * mask + m_flat * (1 - mask)

    def _white_diag(self, blocks=None):
        """diag(P^T N^-1 P) with the white (frequency-mean) noise level
        and SQUARED Stokes weights — signed w_Q/w_U from mixed detector
        angles would cancel per pixel."""
        diag = jnp.zeros(self.n_m, dtype=jnp.float32)
        for block in blocks if blocks is not None else self.blocks:
            white = block["A_inv"].mean(axis=-1, keepdims=True) * jnp.ones_like(block["data"])
            diag = diag + self._project_T(white, {**block, "sw": block["sw"] ** 2})
        return diag

    # -- fused epoch (k = 0) -------------------------------------------------------
    def _epoch_k0(self, m, blocks, n_steps):
        """One full epoch — noise-model update, rhs, Jacobi preconditioner
        and the whole CG solve — as a single traced program. Eagerly the
        epoch is tens of dispatches with host syncs between them, and
        those round-trips can dominate the solve. Fusing the epoch makes
        the per-epoch cost one dispatch + one small readback. Same math as
        _update_noise_model/_rhs/_white_diag/cg, pinned by
        tests/test_ml_mapper.py::test_fused_epoch_matches_eager."""
        new_blocks = []
        medians = []
        for i, b in enumerate(blocks):
            # static plan metadata rides as a closure constant (the
            # index arrays are traced args in `b`) — attached BEFORE the
            # residual projection so P rides the MXU path too
            b = {**b, "bmeta": self.blocks[i].get("bmeta")}
            if "rmeta" in self.blocks[i]:
                b["rmeta"] = self.blocks[i]["rmeta"]
            d = b["data"]
            resid = d - self._project(m, b)
            resid = resid - resid.mean(axis=-1, keepdims=True)
            win = _tukey(resid.shape[-1])
            spec = jnp.abs(jnp.fft.rfft(resid * win, axis=-1)) ** 2 / (win**2).sum()
            spec = _smooth_spectrum(spec, int(self.spectrum_smoothing))
            nb = {**b, "A_inv": 1.0 / jnp.clip(spec, 1e-30, None)}
            new_blocks.append(nb)
            # median over REAL rows only — zero-weight det-padding rows
            # have identically-zero spectra and would drag it to 0
            medians.append(jnp.median(spec[: self.blocks[i]["n_real"]], axis=0))
        rhs = self._rhs(new_blocks)
        diag = self._white_diag(new_blocks)
        inv_diag = jnp.where(diag > 0, 1.0 / jnp.clip(diag, 1e-30, None), 1.0)
        m, _ = jax.scipy.sparse.linalg.cg(
            lambda x: self._apply_PNP(x, new_blocks), rhs, x0=m,
            maxiter=n_steps, tol=1e-8, M=lambda x: x * inv_diag,
        )
        return m, diag, [nb["A_inv"] for nb in new_blocks], medians

    # -- solvers ----------------------------------------------------------------
    def _solve_gd(self, rhs, m0, n_iters):
        """Steepest descent with exact line search on the quadratic
        objective 1/2 m^T H m - rhs^T m (H = sum P^T N^-1 P): the
        on-device replacement for the reference's autograd loop with
        adaptive step (ml_mapper.py:379-485)."""
        m = m0
        for _ in range(n_iters):
            r = rhs - self._apply_PNP(m)
            Hr = self._apply_PNP(r)
            denom = jnp.vdot(r, Hr)
            alpha = jnp.where(denom > 0, jnp.vdot(r, r) / jnp.maximum(denom, 1e-30), 0.0)
            m = m + alpha * r
        return m

    def plot_noise_model(self, epoch: int = -1, ax=None):
        """Per-epoch noise-model diagnostic: median detector PSD (and the
        low-rank mode spectra when k > 0) for each TOD (reference
        ml_mapper.py's per-epoch noise-model plots)."""
        import matplotlib.pyplot as plt

        if not self.noise_model_history:
            raise RuntimeError("No noise model yet — call fit() first.")
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4), constrained_layout=True)
        for i, diag in enumerate(self.noise_model_history[epoch]):
            f = diag["f"][1:]
            ax.loglog(f, diag["median_psd"][1:], label=f"TOD {i} median PSD")
            if diag["mode_psd"] is not None:
                for j, mode in enumerate(diag["mode_psd"]):
                    ax.loglog(f, mode[1:], ls="--", lw=0.8, alpha=0.6,
                              label=f"TOD {i} mode {j}" if j < 3 else None)
        n_epochs = len(self.noise_model_history)
        ax.set_title(f"noise model, epoch {epoch % n_epochs + 1}/{n_epochs}")
        ax.set_xlabel("frequency [Hz]")
        ax.set_ylabel(f"PSD [{self.tod_units}^2 / Hz]")
        ax.legend(fontsize=7)
        return ax

    def _compute_naive_map(self):
        # naive (binned) starting map + hit/weight maps; hit counts use
        # |w_s| so Q/U weights don't cancel
        hits = jnp.zeros(self.n_m, dtype=jnp.float32)
        raw = jnp.zeros(self.n_m, dtype=jnp.float32)
        for block in self.blocks:
            ones = jnp.ones_like(block["data"])
            abs_block = {**block, "sw": jnp.abs(block["sw"])}
            hits = hits + self._project_T(ones, abs_block)
            raw = raw + self._project_T(block["data"], block)
        self.hits = hits
        self.naive_map = jnp.where(hits > 0, raw / jnp.clip(hits, 1e-8, None), 0.0)

    def _grid_to_map(self, m, weights):
        """Assemble a ProjectionMap from flat solution/weight vectors,
        applying the zero-mean convention per covered slice."""
        shape4 = (self.n_s, self.n_nu, self.t_bins, self.n_pix1)
        m_grid = np.asarray(m).reshape(shape4)[..., :-1]
        w_grid = np.asarray(weights).reshape(shape4)[..., :-1]
        h_grid = np.asarray(self.hits).reshape(shape4)[..., :-1]

        data = np.zeros((self.n_s, self.n_nu, self.t_bins, self.n_y, self.n_x), dtype=np.float32)
        weight = np.zeros_like(data)
        for s in range(self.n_s):
            for c in range(self.n_nu):
                for t in range(self.t_bins):
                    img = m_grid[s, c, t].reshape(self.n_y, self.n_x)
                    valid = h_grid[s, c, t].reshape(self.n_y, self.n_x) > 0
                    if valid.any():
                        img = np.where(valid, img - img[valid].mean(), 0.0)
                    data[s, c, t] = img
                    weight[s, c, t] = np.where(valid, w_grid[s, c, t].reshape(self.n_y, self.n_x), 0.0)
        return self.make_map(data, weight)

    def fit(
        self,
        method: str = "conjugate_gradient",
        epochs: int = None,
        steps_per_epoch: int = None,
        max_steps_per_epoch: int = None,
        plot: bool = False,
        plot_kwargs: dict = {},
        fused: bool = True,
    ):
        """Iterate noise-model update + normal-equation solve
        (reference ml_mapper.py:359). `epochs` / `steps_per_epoch` (alias
        `max_steps_per_epoch`) override the constructor's n_epochs /
        n_cg_iters; `plot=True` plots the map after fitting. With
        `fused=True` (default) and k=0 the whole epoch runs as one jit
        dispatch (`_epoch_k0`); `fused=False` forces the stage-by-stage
        eager path (identical math, used for equality testing and as the
        k>0 / gradient-descent path)."""
        n_epochs = epochs if epochs is not None else self.n_epochs
        n_steps = steps_per_epoch or max_steps_per_epoch or self.n_cg_iters
        hits = self.hits
        if self.init == "random":
            key = jax.random.key(0)
            scale = float(jnp.std(self.naive_map)) or 1.0
            m = scale * jax.random.normal(key, (self.n_m,), dtype=jnp.float32)
        else:
            m = self.naive_map

        use_fused = fused and self.k == 0 and method == "conjugate_gradient"
        if use_fused and self._epoch_k0_jit is None:
            # n_steps stays a traced scalar: cg's while_loop takes it in
            # its condition, so one executable serves every iteration
            # count (fit(10)/fit(50) would otherwise each pay a full
            # remote compile)
            self._epoch_k0_jit = jax.jit(self._epoch_k0)

        diag = None
        for epoch in range(n_epochs):
            if use_fused:
                keys = ("pix", "sw", "data") + (
                    ("bly", "blx", "borig", "border", "re", "rly", "rlx",
                     "rorig", "rorder", "rwcnt", "ovf", "cmask", "tmask")
                    if self._mxu_pointing else ()
                )
                light = [{key: b[key] for key in keys if key in b} for b in self.blocks]
                m, diag, a_invs, medians = self._epoch_k0_jit(m, light, jnp.int32(n_steps))
                # keep per-block state and diagnostics identical to the
                # eager path (device-resident; no readback until asked)
                for b, a_inv in zip(self.blocks, a_invs):
                    b["A_inv"], b["U"] = a_inv, None
                self.noise_model_history.append([
                    {
                        "f": np.fft.rfftfreq(b["data"].shape[-1], d=1 / b["fs"]),
                        "median_psd": np.asarray(med),
                        "mode_psd": None,
                    }
                    for b, med in zip(self.blocks, medians)
                ])
            else:
                self._update_noise_model(m)
                rhs = self._rhs()
                if method == "conjugate_gradient":
                    # Jacobi preconditioner: 1 / diag(P^T N^-1 P), estimated
                    # with the white (frequency-mean) noise level and squared
                    # Stokes weights; pixels without coverage get 1
                    diag = self._white_diag()
                    inv_diag = jnp.where(diag > 0, 1.0 / jnp.clip(diag, 1e-30, None), 1.0)
                    m, _ = jax.scipy.sparse.linalg.cg(
                        self._apply_PNP, rhs, x0=m, maxiter=n_steps, tol=1e-8,
                        M=lambda x: x * inv_diag,
                    )
                elif method == "gradient_descent":
                    m = self._solve_gd(rhs, m, n_steps)
                else:
                    raise ValueError(f"Unknown solver '{method}'.")
            logger.info(f"ML mapper epoch {epoch + 1}/{n_epochs} done.")
            if plot:  # per-epoch map plot (reference ml_mapper.py fit(plot=True))
                self._grid_to_map(m, self._white_diag()).plot(**plot_kwargs)

        # inverse-variance pixel weights from the final noise model
        # (reuse the last epoch's preconditioner diagonal — same quantity)
        ivar = diag if diag is not None else self._white_diag()
        self.m = m
        self.map = self._grid_to_map(m, ivar)
        return self.map

    run = fit
