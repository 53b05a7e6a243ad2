"""Maximum-likelihood map-making for observations whose TOD exceeds HBM.

The batch `MaximumLikelihoodMapper` builds its pointing blocks from an
in-memory TOD (like the reference, maria/mappers/ml_mapper.py:127-143);
an out-of-HBM observation (AtLAST-50k x 600 s needs ~20 GB of fine-rate
fields) can only be synthesized through `StreamingExecutor` — which
until round 5 produced *binned* maps only. This module closes that gap
(VERDICT r4 item 4b): it accumulates the normal-equation ingredients
P^T N^-1 d and applies P^T N^-1 P *per streaming block*, so the full
TOD never exists anywhere.

Model (deliberately matched to what the streamed product IS):

- ONE intensity map on the executor's (n_y, n_x) grid — the streamed
  binner's own product (the batch mapper's per-Stokes/per-channel grids
  need per-detector Mueller channels the streamed map doesn't carry).
- Noise covariance block-diagonal over streaming blocks and circulant
  within each: per-detector PSDs are estimated by streamed Welch
  spectra of map-subtracted residuals (the reference's Tukey-windowed
  residual PSD, ml_mapper.py:192-299, estimated per block instead of
  per observation) and applied as FFT -> 1/PSD -> iFFT per block. This
  is the streaming analogue of the reference's diagonal-in-frequency
  model; it cannot represent couplings across block boundaries (~1/B of
  the band at the block rate).
- Off-map samples simply have zero P rows (the streamed maps have no
  overflow bucket); the solved map is zero-meaned per the mapper
  convention.

Epoch loop = the reference's fit() (ml_mapper.py:359): update noise
model from residuals -> rebuild rhs -> CG on the normal equations. The
expensive synthesis (atmosphere + noise) streams ONCE per pass with the
same PRNG key, so every pass sees the identical TOD; CG iterations
never re-synthesize — P^T N^-1 P only needs pointing and spectra, and
the whole solve runs as one fused dispatch over a scan of all blocks
(eager CG would pay a host round-trip per step).

P / P^T ride the same in-scan run-compressed MXU contractions as the
streamed binner (ops/binning_runs.bin_runs_traced / project_runs_traced)
when the executor's geometry allows, falling back to gather/segment-sum
otherwise; the two paths are equality-tested.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("maria_tpu")

__all__ = ["StreamingMLMapper"]


def _hann(n):
    return 0.5 - 0.5 * jnp.cos(2 * jnp.pi * jnp.arange(n) / n)


class StreamingMLMapper:
    """ML map-making over `StreamingExecutor` blocks (module docstring).

    Parameters
    ----------
    executor:
        A configured StreamingExecutor (program + obs + map geometry).
        Sky stages (cmb=/input_map=) stream into the TOD exactly as in
        executor.run().
    n_epochs, n_cg_iters, spectrum_smoothing:
        The reference fit() knobs (maria/mappers/ml_mapper.py:359).
    use_runs:
        None (default) auto-picks the run-compressed MXU pointing when
        the executor's blocked geometry qualifies; False forces the
        gather/segment-sum path (CPU, equality tests).
    """

    def __init__(
        self,
        executor,
        n_epochs: int = 2,
        n_cg_iters: int = 30,
        spectrum_smoothing: float = 8.0,
        group_size: int = 8,
        use_runs: bool = None,
    ):
        self.ex = executor
        self.n_epochs = n_epochs
        self.n_cg_iters = n_cg_iters
        self.spectrum_smoothing = max(int(spectrum_smoothing), 1)
        self.group_size = group_size
        if use_runs is None:
            use_runs = executor._bin_plan is not None and executor._run_params is not None
        elif use_runs and (executor._bin_plan is None or executor._run_params is None):
            raise ValueError(
                "use_runs=True but the executor's geometry has no run-compressed "
                "plan (window too wide or scan too fast) — use use_runs=False."
            )
        self.use_runs = use_runs
        self._pixel_fn = executor._make_pixel_fn()
        self._nf = executor.B // 2 + 1
        self._jits = {}
        self.noise_model_history = []

    # -- pointing operators (per block) ---------------------------------
    def _run_statics(self):
        ex = self.ex
        bp, rp = ex._bin_plan, ex._run_params
        return dict(
            n_det=ex.n_det, det_block=bp.det_block, n_blocks=bp.n_blocks,
            n_chunks=bp.n_chunks, chunk=bp.chunk, seg=rp["seg"],
            r_max=rp["r_max"], wy=bp.wy, wx=bp.wx, n_y=ex.n_y, n_x=ex.n_x,
        )

    def _orders(self):
        order = self.ex._bin_plan.order  # padded: tail repeats the last det
        n_det = self.ex.n_det
        inv = np.zeros(n_det, np.int32)
        inv[order[:n_det]] = np.arange(n_det, dtype=np.int32)
        return jnp.asarray(order), jnp.asarray(inv)

    def _project(self, m_img, iy, ix, inside):
        """P m -> (n_det, B); 0 off-map."""
        ex = self.ex
        if self.use_runs:
            from ..ops.binning_runs import project_runs_traced

            order, inv = self._orders()
            samp = project_runs_traced(
                m_img, jnp.where(inside, iy, -1), jnp.where(inside, ix, -1),
                order, inv, **self._run_statics(),
            )
            return samp[:, : ex.B]
        pix = jnp.where(inside, iy * ex.n_x + ix, ex.n_x * ex.n_y)
        m1 = jnp.concatenate([m_img.reshape(-1), jnp.zeros((1,), m_img.dtype)])
        return jnp.take(m1, pix, axis=0)

    def _project_T(self, v, iy, ix, inside):
        """P^T v -> ((n_y, n_x) sum map, (n_y, n_x) hit map, lost)."""
        ex = self.ex
        if self.use_runs:
            from ..ops.binning_runs import bin_runs_traced

            order, _ = self._orders()
            # hilo: zero data stays exactly zero — the shifted restore's
            # cancellation residue breaks CG (bin_runchunk's hilo note)
            return bin_runs_traced(
                v, jnp.where(inside, iy, -1), jnp.where(inside, ix, -1),
                order, precision="hilo", **self._run_statics(),
            )
        from ..ops.binning import bin_scatter

        pix = jnp.where(inside, iy * ex.n_x + ix, ex.n_x * ex.n_y)
        w = inside.astype(v.dtype)
        s = bin_scatter(v * w, pix, ex.n_x * ex.n_y + 1)[:-1]
        h = bin_scatter(w, pix, ex.n_x * ex.n_y + 1)[:-1]
        shape = (ex.n_y, ex.n_x)
        return s.reshape(shape), h.reshape(shape), jnp.float32(0.0)

    @staticmethod
    def _unpack_xs(xs1):
        """One block's xs leaves -> (b, az_b, el_b, sky_b_or_None)."""
        if len(xs1) == 4:
            return xs1[0], xs1[1], xs1[2], xs1[3]
        return xs1[0], xs1[1], xs1[2], None

    # -- streamed passes ------------------------------------------------
    def _synthesis_pass(self, key, kind: str, m_img, A_inv=None):
        """Stream the synthesis once, accumulating `kind`:
        - "spec": per-detector Welch power of map-subtracted residuals
          (full blocks only) -> (spec_sum (n_det, n_f), n_full)
        - "rhs": P^T N^-1 d sum map + white-noise diag map + lost
        """
        ex = self.ex
        jkey = (kind, self.use_runs)
        if jkey not in self._jits:
            base_fn = ex._make_block_fn(with_tod=True, with_map=False)
            pixel_fn = self._pixel_fn
            B = ex.B

            def group(carry, xs):
                def one(carry, xs1):
                    inner, acc, m_c, A_c = carry
                    inner2, tod = base_fn(inner, xs1)
                    b, az_b, el_b, sky_b = self._unpack_xs(xs1)
                    iy, ix, inside = pixel_fn(b, az_b, el_b, sky_b)
                    full = (
                        ((b + 1) * B <= ex.n_t).astype(jnp.float32)
                        * (b < ex.n_blocks).astype(jnp.float32)
                    )
                    if kind == "spec":
                        resid = tod - self._project(m_c, iy, ix, inside)
                        resid = resid - resid.mean(axis=-1, keepdims=True)
                        win = _hann(B)
                        spec = jnp.abs(jnp.fft.rfft(resid * win, axis=-1)) ** 2 / (
                            win**2
                        ).sum()
                        acc = (acc[0] + full * spec, acc[1] + full)
                    else:  # rhs
                        fv = jnp.fft.rfft(tod, axis=-1)
                        w = jnp.fft.irfft(A_c * fv, n=B, axis=-1)
                        s, _, lost = self._project_T(w, iy, ix, inside)
                        white = jnp.broadcast_to(
                            A_c.mean(axis=-1, keepdims=True), tod.shape
                        )
                        dg, _, _ = self._project_T(white, iy, ix, inside)
                        acc = (acc[0] + s, acc[1] + dg, acc[2] + lost)
                    return (inner2, acc, m_c, A_c), ()

                carry, _ = jax.lax.scan(one, carry, xs)
                return carry

            self._jits[jkey] = jax.jit(group)
        run = self._jits[jkey]

        inner = ex.init_state(key)
        if kind == "spec":
            acc = (jnp.zeros((ex.n_det, self._nf), jnp.float32), jnp.float32(0.0))
            A_c = jnp.zeros((ex.n_det, self._nf), jnp.float32)
        else:
            acc = (
                jnp.zeros((ex.n_y, ex.n_x), jnp.float32),
                jnp.zeros((ex.n_y, ex.n_x), jnp.float32),
                jnp.float32(0.0),
            )
            A_c = A_inv
        carry = (inner, acc, m_img, A_c)
        for _, _, xs in ex._xs_groups(0, self.group_size):
            carry = run(carry, xs)
        return carry[1]

    # -- fused CG -------------------------------------------------------
    def _cg_solve(self, m0, rhs, diag, A_inv, n_iters):
        ex = self.ex
        jkey = ("cg", self.use_runs)
        if jkey not in self._jits:
            pixel_fn = self._pixel_fn
            B = ex.B

            az = ex.bs_az_f.reshape(ex.n_blocks, ex.B)
            el = ex.bs_el_f.reshape(ex.n_blocks, ex.B)
            need_tracks = ex.sky is not None or ex.frame == "ra/dec"
            sky_ext = ex._sky_track_blocks() if need_tracks else None
            xs_all = (jnp.arange(ex.n_blocks), jnp.asarray(az), jnp.asarray(el))
            if sky_ext is not None:
                xs_all = (*xs_all, tuple(jnp.asarray(a) for a in sky_ext))
            self._cg_xs = xs_all

            def A_op(x_img, A_c, xs_all):
                def blk(acc, xs1):
                    b, az_b, el_b, sky_b = self._unpack_xs(xs1)
                    iy, ix, inside = pixel_fn(b, az_b, el_b, sky_b)
                    Px = self._project(x_img, iy, ix, inside)
                    w = jnp.fft.irfft(A_c * jnp.fft.rfft(Px, axis=-1), n=B, axis=-1)
                    s, _, _ = self._project_T(w, iy, ix, inside)
                    return acc + s, ()

                out, _ = jax.lax.scan(
                    blk, jnp.zeros((ex.n_y, ex.n_x), jnp.float32), xs_all
                )
                return out

            def solve(m0, rhs, inv_diag, A_c, xs_all, n_iters):
                def body(i, st):
                    m, r, z, p_vec, rz = st
                    Ap = A_op(p_vec, A_c, xs_all)
                    alpha = rz / jnp.maximum(jnp.vdot(p_vec, Ap), 1e-30)
                    m = m + alpha * p_vec
                    r = r - alpha * Ap
                    z = r * inv_diag
                    rz_new = jnp.vdot(r, z)
                    beta = rz_new / jnp.maximum(rz, 1e-30)
                    return (m, r, z, z + beta * p_vec, rz_new)

                r0 = rhs - A_op(m0, A_c, xs_all)
                z0 = r0 * inv_diag
                st = (m0, r0, z0, z0, jnp.vdot(r0, z0))
                st = jax.lax.fori_loop(0, n_iters, body, st)
                return st[0]

            self._jits[jkey] = jax.jit(solve, static_argnames=())
        inv_diag = jnp.where(diag > 0, 1.0 / jnp.clip(diag, 1e-30, None), 1.0)
        return self._jits[jkey](
            m0, rhs, inv_diag, A_inv, self._cg_xs, jnp.int32(n_iters)
        )

    # -- public ---------------------------------------------------------
    def fit(self, key=None):
        """Stream the epochs; returns the solved (n_y, n_x) intensity
        map (zero-meaned over covered pixels). Also sets `.naive_map`,
        `.hits`, `.m`, `.diag`."""
        ex = self.ex
        key = key if key is not None else jax.random.key(0)

        naive = ex.run(key, group_size=self.group_size)
        hits = naive.map_wgt
        covered = hits > 0
        m = jnp.asarray(
            np.where(covered, naive.map_sum / np.clip(hits, 1e-8, None), 0.0),
            dtype=jnp.float32,
        )
        self.naive_map = np.asarray(m)
        self.hits = hits

        diag = None
        for epoch in range(self.n_epochs):
            spec_sum, n_full = self._synthesis_pass(key, "spec", m)
            spec = np.asarray(spec_sum) / max(float(n_full), 1.0)
            k = self.spectrum_smoothing
            if k > 1:  # boxcar smoothing along frequency (host, once)
                kernel = np.ones(k) / k
                spec = np.apply_along_axis(
                    lambda s: np.convolve(s, kernel, mode="same"), -1, spec
                )
            A_inv = jnp.asarray(1.0 / np.clip(spec, 1e-30, None), jnp.float32)
            self.noise_model_history.append({
                "f": np.fft.rfftfreq(ex.B, d=1.0 / ex.program.sample_rate),
                "median_psd": np.median(spec[: ex.n_real_det], axis=0),
            })
            rhs, diag, lost = self._synthesis_pass(key, "rhs", m, A_inv=A_inv)
            if float(lost):
                raise RuntimeError(
                    f"run-compressed pointing dropped {float(lost):.0f} samples — "
                    "static run/window bound violated; use use_runs=False."
                )
            m = self._cg_solve(m, rhs, diag, A_inv, self.n_cg_iters)
            logger.info("streamed ML epoch %d/%d done", epoch + 1, self.n_epochs)

        m_np = np.asarray(m)
        m_np = np.where(covered, m_np - m_np[covered].mean(), 0.0)
        self.m = m_np
        self.diag = np.asarray(diag)
        return m_np

    run = fit
