"""Binned map-making (reference: maria/mappers/bin_mapper.py:24-112).

On the device: the sparse pointing matrix of the reference becomes
run-compressed one-hot contractions (ops/binning_runs.py) over static
pixel ids, or a jax.ops.segment_sum scatter where the geometry defeats
them — one program per (TOD, band): offsets -> pixel ids -> weighted
binning of data and weights. On a device mesh the per-shard partial maps are psum-reduced
(see maria_tpu.parallel).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from ..coords.transforms import phi_theta_to_offsets_jit
from ..ops.binning import bin_blocked, hilbert_detector_order, make_blocked_bin_plan
from ..ops.binning_runs import bin_runchunk, make_runchunk_bin_plan_on_device
from .base import BaseProjectionMapper

logger = logging.getLogger("maria_tpu")


def _bin_tod_block(data, weight, dx, dy, stokes_w, x0, y0, res, n_x, n_y, n_stokes):
    """Scatter one block of samples into per-Stokes (sum, wgt) maps.

    Pure jnp: nearest-pixel segment-sum. data/weight/dx/dy are
    (n_det, n_t); stokes_w is (n_det, n_stokes).
    """
    ix = jnp.round((dx - x0) / res).astype(jnp.int32)
    iy = jnp.round((dy - y0) / res).astype(jnp.int32)
    inside = (ix >= 0) & (ix < n_x) & (iy >= 0) & (iy < n_y)
    flat = jnp.where(inside, iy * n_x + ix, n_x * n_y)  # overflow bucket

    sums = []
    wgts = []
    for s in range(n_stokes):
        w_s = stokes_w[:, s][:, None]
        num = jax.ops.segment_sum(
            (weight * w_s * data).ravel(), flat.ravel(), num_segments=n_x * n_y + 1
        )
        den = jax.ops.segment_sum(
            (weight * jnp.abs(w_s)).ravel(), flat.ravel(), num_segments=n_x * n_y + 1
        )
        sums.append(num[:-1].reshape(n_y, n_x))
        wgts.append(den[:-1].reshape(n_y, n_x))
    return jnp.stack(sums), jnp.stack(wgts)


_bin_tod_block_jit = jax.jit(_bin_tod_block, static_argnames=("n_x", "n_y", "n_stokes"))


class BinMapper(BaseProjectionMapper):
    def run(self, mesh=None):
        """Bin all TODs into the map. With a ("det", "time") `mesh`,
        each (TOD, band, time-bin) block bins through the production
        multi-chip kernel (parallel/binning.py: per-shard MXU plans +
        one psum) — the result equals the single-device run (tested).
        Detector/time axes are padded with zero-weight samples to the
        mesh shape."""
        n_s, n_nu, n_t = len(self.stokes), len(self.nu), self.t_bins
        mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh is not None else None
        # accumulate ON DEVICE across all blocks; the only device->host
        # transfer is the final one (reference hauled every sparse-matvec
        # product back per TOD, bin_mapper.py:100-112)
        sums = jnp.zeros((n_s, n_nu, n_t, self.n_y, self.n_x), dtype=jnp.float32)
        wgts = jnp.zeros_like(sums)

        stokes_idx = ["IQUV".index(s) for s in self.stokes]
        x0 = -(self.n_x - 1) / 2 * self.res
        y0 = -(self.n_y - 1) / 2 * self.res

        from ..io.logging import progress_bar

        for tod in progress_bar(self.tods, desc="Binning TODs", disable=not self.progress_bars):
            # detector offsets from the map center in the map frame
            pointing = tod.pointing
            if self.frame.name == "ra/dec":
                ra, dec = pointing.det_radec()
                pt = jnp.stack([ra, dec], axis=-1)
            else:
                az, el = pointing.det_azel()
                pt = jnp.stack([az, el], axis=-1)
            offsets = phi_theta_to_offsets_jit(pt, self.center[0], self.center[1])
            dx, dy = offsets[..., 0], offsets[..., 1]

            t_index = np.digitize(np.asarray(tod.time), self.t_edges) - 1
            data = tod.signal
            weight = tod.weight

            for i_nu, band in enumerate(self.bands):
                band_idx = np.where(tod.dets.band_name == band.name)[0]
                if len(band_idx) == 0:
                    continue
                sw = jnp.asarray(
                    tod.dets.stokes_weight()[band_idx][:, stokes_idx], dtype=jnp.float32
                )
                # pixel indices once per band (ONE host readback; they
                # are static pointing, not data)
                bx = np.asarray(dx[band_idx])
                by = np.asarray(dy[band_idx])
                ix_all = np.round((bx - x0) / self.res).astype(np.int32)
                iy_all = np.round((by - y0) / self.res).astype(np.int32)
                inside = (ix_all >= 0) & (ix_all < self.n_x) & (iy_all >= 0) & (iy_all < self.n_y)
                ix_all = np.where(inside, ix_all, -1)
                iy_all = np.where(inside, iy_all, -1)
                try_windowed = True
                try_runs = True
                # the Hilbert detector sort depends only on the (shared)
                # pointing — compute once per band, reuse for every t bin
                det_order = hilbert_detector_order(iy_all, ix_all)
                shard_orders = (
                    self._shard_orders(iy_all, ix_all, mesh_sizes) if mesh is not None else None
                )

                for i_t in range(n_t):
                    cols = np.where(t_index == i_t)[0]
                    if len(cols) == 0:
                        continue
                    sl = slice(cols[0], cols[-1] + 1)

                    # hot path: run-compressed MXU binning on the static
                    # pointing (ops/binning_runs.py, 2x the blocked path
                    # at AtLAST scale) -> det-blocked -> scatter for
                    # pathological scan/map geometries
                    rplan = (
                        make_runchunk_bin_plan_on_device(
                            iy_all[:, sl], ix_all[:, sl], self.n_y, self.n_x,
                            order=det_order,
                        )
                        if try_runs
                        else None
                    )
                    if rplan is None:
                        try_runs = False  # pathological: stop re-trying per bin
                    plan = rplan
                    if plan is None:
                        plan = (
                            make_blocked_bin_plan(
                                iy_all[:, sl], ix_all[:, sl], self.n_y, self.n_x,
                                order=det_order,
                            )
                            if try_windowed
                            else None
                        )
                        if plan is None:
                            try_windowed = False  # stop re-trying per bin
                    if plan is not None:
                        # one channel-stacked call: [w_s*W*D per Stokes,
                        # |w_s|*W per Stokes] share the one-hot hats
                        d_block = data[band_idx, sl]
                        w_block_in = weight[band_idx, sl]
                        channels = jnp.stack(
                            [w_block_in * sw[:, s][:, None] * d_block for s in range(len(stokes_idx))]
                            + [w_block_in * jnp.abs(sw[:, s])[:, None] for s in range(len(stokes_idx))]
                        )
                        n_sk = len(stokes_idx)
                        if mesh is not None:
                            binned = self._bin_sharded(
                                channels, iy_all[:, sl], ix_all[:, sl], mesh, mesh_sizes,
                                shard_orders,
                            )
                        else:
                            binned = None
                        if binned is None:
                            if rplan is not None:
                                # hilo: the weight channels fluctuate at
                                # the signal scale (processing windows),
                                # outside the one-pass shifted bound
                                binned = bin_runchunk(channels, rplan, precision="hilo")
                            else:
                                binned = bin_blocked(channels, plan)
                        sums = sums.at[:, i_nu, i_t].add(binned[:n_sk])
                        wgts = wgts.at[:, i_nu, i_t].add(binned[n_sk:])
                        continue

                    s_block, w_block = _bin_tod_block_jit(
                        data[band_idx, sl], weight[band_idx, sl],
                        dx[band_idx, sl], dy[band_idx, sl], sw,
                        x0, y0, self.res, self.n_x, self.n_y, len(stokes_idx),
                    )
                    sums = sums.at[:, i_nu, i_t].add(s_block)
                    wgts = wgts.at[:, i_nu, i_t].add(w_block)

        data, weights = self.postprocess(np.asarray(sums), np.asarray(wgts))
        self.map = self.make_map(data, weights)
        return self.map

    def _shard_orders(self, iy_all, ix_all, sizes):
        """Per-det-shard Hilbert orders over the FULL time range, shared
        by every time bin's sharded plan (the sort depends only on the
        pointing)."""
        n_ds = sizes.get("det", 1)
        pad_d = -iy_all.shape[0] % n_ds
        if pad_d:
            iy_all = np.pad(iy_all, ((0, pad_d), (0, 0)), constant_values=-1)
            ix_all = np.pad(ix_all, ((0, pad_d), (0, 0)), constant_values=-1)
        d_local = iy_all.shape[0] // n_ds
        return [
            hilbert_detector_order(
                iy_all[i * d_local : (i + 1) * d_local],
                ix_all[i * d_local : (i + 1) * d_local],
            )
            for i in range(n_ds)
        ]

    def _bin_sharded(self, channels, iy, ix, mesh, sizes, shard_orders=None):
        """One (TOD, band, bin) block through the multi-chip MXU path;
        None when the per-shard windows would not pay (caller falls back
        to the single-device plan)."""
        from ..parallel.binning import bin_blocked_sharded, make_sharded_bin_plan

        n_ds = sizes.get("det", 1)
        n_ts = sizes.get("time", 1)
        pad_d = -iy.shape[0] % n_ds
        pad_t = -iy.shape[1] % n_ts
        if pad_d or pad_t:
            iy = np.pad(iy, ((0, pad_d), (0, pad_t)), constant_values=-1)
            ix = np.pad(ix, ((0, pad_d), (0, pad_t)), constant_values=-1)
            channels = jnp.pad(channels, ((0, 0), (0, pad_d), (0, pad_t)))
        plan = make_sharded_bin_plan(iy, ix, self.n_y, self.n_x, mesh, orders=shard_orders)
        if plan is None:
            return None
        return bin_blocked_sharded(channels, plan, mesh)
