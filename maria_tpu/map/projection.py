"""Flat-sky projected maps (reference: maria/map/projection.py:28-780).

Data shape (stokes, nu, t, eta, xi). The pointing "matrix" is never
materialized: `sample` is a (bilinear) gather fused into the simulation
program, and `bin` (used by the mappers) is a segment-sum scatter —
the device equivalents of the reference's scipy CSR matrices
(projection.py:134-179).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from ..beam import gaussian_beam_fft_filter
from ..units import Quantity
from .base import Map

logger = logging.getLogger("maria_tpu")


class ProjectionMap(Map):
    map_dims = ("eta", "xi")

    def __init__(
        self,
        data,
        center=(0.0, 0.0),
        width=None,
        height=None,
        resolution=None,
        frame: str = "ra/dec",
        stokes: str = None,
        nu=None,
        t=None,
        z=None,
        v=None,
        units: str = "K_RJ",
        weight=None,
        degrees: bool = True,
        dtype=jnp.float32,
    ):
        super().__init__(
            data, stokes=stokes, nu=nu, t=t, z=z, v=v, units=units, weight=weight, dtype=dtype
        )
        self.frame = frame
        n_eta, n_xi = self.data.shape[-2:]

        to_rad = np.pi / 180 if degrees else 1.0
        self.center = (float(center[0]) * to_rad, float(center[1]) * to_rad)

        # resolve center/width/resolution (reference projection.py:101-132)
        if resolution is not None:
            res = float(resolution) * to_rad
            width = res * n_xi
            height = res * n_eta
        elif width is not None:
            width = float(width) * to_rad
            height = float(height) * to_rad if height is not None else width * n_eta / n_xi
            res = width / n_xi
        else:
            raise ValueError("Supply either 'width' or 'resolution'.")
        self._width, self._height, self._res = width, height, res

        # pixel centers as tangent-plane offsets from the map center
        self.x_side = (np.arange(n_xi) - (n_xi - 1) / 2) * res
        self.y_side = (np.arange(n_eta) - (n_eta - 1) / 2) * (height / n_eta)

    def _replace(self, **kwargs):
        params = dict(
            data=self.data,
            center=np.degrees(self.center),
            width=np.degrees(self._width),
            height=np.degrees(self._height),
            frame=self.frame,
            stokes=self.stokes,
            nu=self.nu,
            **self._axis3_kwargs(),
            units=self.units,
            weight=self.weight,
            degrees=True,
        )
        if any(k in kwargs for k in ("t", "z", "v")):
            params.pop(self.axis3_label, None)
        params.update(kwargs)
        return ProjectionMap(**params)

    def _calibration_kwargs(self):
        return {"pixel_area": self.pixel_area}

    def __getitem__(self, key):
        """Slice the leading (stokes, nu, t) dims, keeping axes
        (reference projection.py:240: `m[:, 0]` selects a nu channel,
        `m[:, :, -1]` a time frame). Map dims must be left whole — use
        `trim`/`reduce` for spatial cropping."""
        key = key if isinstance(key, tuple) else (key,)
        if len(key) > 5:
            raise IndexError(f"Too many indices for a 5-D map: {key}.")
        full = list(key) + [slice(None)] * (5 - len(key))
        for ax in (3, 4):
            if full[ax] != slice(None):
                raise NotImplementedError("Use trim/reduce to crop map dims.")
        norm = []
        for ax, k in enumerate(full[:3]):
            if isinstance(k, (int, np.integer)):
                k = int(k) % self.data.shape[ax]
                norm.append(slice(k, k + 1))
            else:
                norm.append(k)
        sl = tuple(norm) + (slice(None), slice(None))
        kwargs = {"data": self.data[sl], "weight": self.weight[sl],
                  "stokes": self.stokes[norm[0]], "nu": self.nu[norm[1]],
                  self.axis3_label: self.t[norm[2]]}
        if any(k in kwargs for k in ("t", "z", "v")):
            pass  # _replace drops the old axis3 kwarg itself
        return self._replace(**kwargs)

    @property
    def n_x(self):
        return self.data.shape[-1]

    @property
    def n_y(self):
        return self.data.shape[-2]

    # reference parity (projection.py:314-328): sizes as unit-carrying
    # Quantities, so `m.width.deg` / `m.resolution.arcmin` work
    @property
    def width(self):
        return Quantity(self._width, "rad")

    @property
    def height(self):
        return Quantity(self._height, "rad")

    @property
    def resolution(self):
        return Quantity(self._res, "rad")

    @property
    def xi_res(self):
        return Quantity(self._res, "rad")

    @property
    def eta_res(self):
        return Quantity(self._height / self.n_y, "rad")

    @property
    def pixel_area(self) -> float:
        return float(self._res * (self._height / self.n_y))

    @property
    def x_res(self) -> float:
        return float(self._res)

    @property
    def y_res(self) -> float:
        return float(self._height / self.n_y)

    # -- device sampling / binning -------------------------------------------------
    def sample(self, dx, dy, stokes_weight=None, nu_index: int = 0, t_index: int = 0, bilinear: bool = True):
        """Sample the map at tangent-plane offsets (dx, dy) from its center.

        Returns Stokes-weighted values: sum_s w_s * map_s(dx, dy). Pure
        jnp; out-of-map samples return 0.
        """
        from ..ops.interp import interp_bilinear_grid

        x_side = jnp.asarray(self.x_side)
        y_side = jnp.asarray(self.y_side)
        out = 0.0
        for s in range(self.n_stokes):
            if stokes_weight is None:
                w = 1.0 if s == 0 else 0.0
            else:
                w = stokes_weight[:, s][:, None]
            if isinstance(w, float) and w == 0.0:
                continue
            # jnp-ify: storage is host numpy, but sample() may be traced
            field = jnp.asarray(self.data[s, nu_index, t_index])
            if bilinear:
                vals = interp_bilinear_grid(field, dx, dy, x_side, y_side)
            else:
                ix = jnp.clip(jnp.round((dx - x_side[0]) / self.x_res).astype(jnp.int32), 0, self.n_x - 1)
                iy = jnp.clip(jnp.round((dy - y_side[0]) / self.y_res).astype(jnp.int32), 0, self.n_y - 1)
                inside = (
                    (dx >= x_side[0] - self.x_res / 2) & (dx <= x_side[-1] + self.x_res / 2)
                    & (dy >= y_side[0] - self.y_res / 2) & (dy <= y_side[-1] + self.y_res / 2)
                )
                vals = jnp.where(inside, field[iy, ix], 0.0)
            out = out + w * vals
        return out

    def pixel_index(self, dx, dy):
        """Flattened nearest-pixel index and validity mask for offsets."""
        ix = jnp.round((dx - self.x_side[0]) / self.x_res).astype(jnp.int32)
        iy = jnp.round((dy - self.y_side[0]) / self.y_res).astype(jnp.int32)
        inside = (ix >= 0) & (ix < self.n_x) & (iy >= 0) & (iy < self.n_y)
        flat = jnp.clip(iy, 0, self.n_y - 1) * self.n_x + jnp.clip(ix, 0, self.n_x - 1)
        return flat, inside

    # -- image-space ops --------------------------------------------------------------
    def smooth(self, fwhm) -> "ProjectionMap":
        """Gaussian beam smoothing as a Fourier multiply
        (reference projection.py:485, weight-aware)."""
        fwhm_rad = float(Quantity(fwhm, "rad").rad) if not hasattr(fwhm, "rad") else float(fwhm.rad)
        F = gaussian_beam_fft_filter((self.n_y, self.n_x), self.y_res, self.x_res, fwhm_rad)
        flat = self.data.reshape(-1, self.n_y, self.n_x)
        smoothed = jnp.fft.irfft2(jnp.fft.rfft2(flat) * F, s=(self.n_y, self.n_x))
        return self._replace(data=smoothed.reshape(self.data.shape))

    def zero_pad(self, factor: float = 1.5) -> "ProjectionMap":
        new_ny = int(self.n_y * factor)
        new_nx = int(self.n_x * factor)
        pad_y = (new_ny - self.n_y) // 2
        pad_x = (new_nx - self.n_x) // 2
        padded = jnp.pad(
            self.data, [(0, 0), (0, 0), (0, 0), (pad_y, new_ny - self.n_y - pad_y), (pad_x, new_nx - self.n_x - pad_x)]
        )
        return ProjectionMap(
            data=padded, center=np.degrees(self.center), resolution=np.degrees(self._res),
            frame=self.frame, stokes=self.stokes, nu=self.nu, **self._axis3_kwargs(), units=self.units,
        )

    def recenter(self, center, degrees: bool = True) -> "ProjectionMap":
        """Resample onto the same grid around a new center
        (reference projection.py:405)."""
        from ..coords.transforms import offsets_to_phi_theta, phi_theta_to_offsets
        from ..ops.interp import interp_bilinear_grid

        new_center = np.radians(np.asarray(center, dtype=float)) if degrees else np.asarray(center, dtype=float)
        # where the new grid's pixels land in the old grid's offsets
        X, Y = np.meshgrid(self.x_side, self.y_side)
        pt = offsets_to_phi_theta(np.stack([X, Y], axis=-1), new_center[0], new_center[1])
        old = np.asarray(phi_theta_to_offsets(pt, self.center[0], self.center[1]))

        def resample(cube):
            flat = cube.reshape(-1, self.n_y, self.n_x)
            out = jnp.stack(
                [
                    interp_bilinear_grid(f, old[..., 0], old[..., 1], self.x_side, self.y_side)
                    for f in flat
                ]
            )
            return out.reshape(cube.shape)

        return ProjectionMap(
            data=resample(self.data), center=np.degrees(new_center),
            resolution=np.degrees(self._res), frame=self.frame,
            stokes=self.stokes, nu=self.nu, **self._axis3_kwargs(), units=self.units,
            weight=resample(self.weight) if self.weight is not None else None,
        )

    def trim(self) -> "ProjectionMap":
        """Crop to the bounding box of nonzero weight."""
        w = np.asarray(self.weight).sum(axis=(0, 1, 2))
        rows = np.where(w.sum(axis=1) > 0)[0]
        cols = np.where(w.sum(axis=0) > 0)[0]
        if len(rows) == 0:
            return self
        sl = (slice(None), slice(None), slice(None), slice(rows[0], rows[-1] + 1), slice(cols[0], cols[-1] + 1))
        return ProjectionMap(
            data=self.data[sl], center=np.degrees(self.center), resolution=np.degrees(self._res),
            frame=self.frame, stokes=self.stokes, nu=self.nu, **self._axis3_kwargs(), units=self.units,
            weight=self.weight[sl],
        )

    def reduce(self, factor: int) -> "ProjectionMap":
        """Block-average downsample (reference projection.py:427)."""
        ny = (self.n_y // factor) * factor
        nx = (self.n_x // factor) * factor
        d = self.data[..., :ny, :nx].reshape(*self.data.shape[:3], ny // factor, factor, nx // factor, factor)
        return ProjectionMap(
            data=d.mean(axis=(-3, -1)), center=np.degrees(self.center),
            resolution=np.degrees(self._res * factor), frame=self.frame,
            stokes=self.stokes, nu=self.nu, **self._axis3_kwargs(), units=self.units,
        )

    def resample(self, resolution=None, shape=None) -> "ProjectionMap":
        from ..ops.interp import interp_bilinear_grid

        if resolution is not None:
            res = float(resolution)
            nx = int(self._width / res)
            ny = int(self._height / res)
        else:
            ny, nx = shape
        new_x = (np.arange(nx) - (nx - 1) / 2) * self._width / nx
        new_y = (np.arange(ny) - (ny - 1) / 2) * self._height / ny
        X, Y = np.meshgrid(new_x, new_y)
        flat = self.data.reshape(-1, self.n_y, self.n_x)
        out = jnp.stack(
            [interp_bilinear_grid(f, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(self.x_side), jnp.asarray(self.y_side)) for f in flat]
        )
        return ProjectionMap(
            data=out.reshape(*self.data.shape[:3], ny, nx), center=np.degrees(self.center),
            width=np.degrees(self._width), height=np.degrees(self._height), frame=self.frame,
            stokes=self.stokes, nu=self.nu, **self._axis3_kwargs(), units=self.units,
        )

    # -- i/o -------------------------------------------------------------------------
    def to_hdf(self, path: str):
        from ..utils import require

        h5py = require("h5py")
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=np.asarray(self.data))
            f.create_dataset("weight", data=np.asarray(self.weight))
            f.attrs["stokes"] = self.stokes
            f.attrs["units"] = self.units
            f.attrs["frame"] = self.frame
            f.attrs["center_deg"] = np.degrees(self.center)
            f.attrs["resolution_deg"] = np.degrees(self._res)
            f.create_dataset("nu", data=self.nu)
            f.attrs["axis3_label"] = self.axis3_label
            f.create_dataset("t", data=self.t)

    def to_fits(self, path: str):
        from ..io.fits import write_fits_map

        write_fits_map(self, path)

    def plot(self, slices=None, nu_index=None, t_index=None, stokes=None, ax=None, cmap="cmb", **kwargs):
        """Panel-grid plot over slice dims (reference projection.py:589):
        `slices="all"` or e.g. `{"stokes": ["I", "Q"], "nu": [[0], [1]]}`.
        The single-panel form (nu_index/t_index/stokes/ax) is kept."""
        if slices is None and ax is None and (nu_index, t_index, stokes) == (None, None, None):
            slices = {}
        if slices is not None:
            from ..plotting.map import plot_map_slices

            return plot_map_slices(self, slices=slices, cmap=cmap, **kwargs)
        from ..plotting.map import plot_projection_map

        return plot_projection_map(
            self, nu_index=nu_index or 0, t_index=t_index or 0, stokes=stokes or "I", ax=ax, cmap=cmap, **kwargs
        )

    def sampled_onto(self, other: "ProjectionMap") -> np.ndarray:
        """This map's data sampled (bilinearly) at `other`'s pixel grid,
        shape (n_stokes, n_nu, n_t, other.n_y, other.n_x). Handles
        center offsets within a shared frame."""
        from ..coords.transforms import offsets_to_phi_theta, phi_theta_to_offsets

        X, Y = np.meshgrid(other.x_side, other.y_side)
        pts = np.stack([X, Y], axis=-1)
        if not np.allclose(self.center, other.center):
            pt = offsets_to_phi_theta(pts, other.center[0], other.center[1])
            pts = phi_theta_to_offsets(pt, self.center[0], self.center[1])
        dx = jnp.asarray(pts[..., 0], dtype=jnp.float32)
        dy = jnp.asarray(pts[..., 1], dtype=jnp.float32)
        from ..ops.interp import interp_bilinear_grid

        out = np.zeros((self.n_stokes, self.n_nu, len(self.t), other.n_y, other.n_x), dtype=np.float32)
        xs = jnp.asarray(self.x_side)
        ys = jnp.asarray(self.y_side)
        for idx in np.ndindex(out.shape[:3]):
            out[idx] = np.asarray(
                interp_bilinear_grid(jnp.asarray(self.data[idx]), dx, dy, xs, ys)
            )
        return out

    def transfer_function(
        self,
        input_map=None,
        n_bins: int = 20,
        stokes: str = "I",
        slices: dict = None,
        t_index: int = 0,
        window="hann",
        taper: float = 0.1,
        pad_factor: float = 1.0,
    ) -> "TransferFunction":
        """Spatial transfer function vs an input map (reference
        projection.py:506): per-frequency cross-spectra T(k). The input
        map defaults to the one propagated by the mapper from the
        simulation's `map=` argument."""
        from .transfer import TransferFunction, compute_transfer_function

        input_map = input_map if input_map is not None else getattr(self, "_input_map", None)
        if input_map is None:
            raise ValueError(
                "No input map: pass input_map=, or build this map with a mapper whose "
                "TODs came from a Simulation(map=...)."
            )
        # align the input onto this map's pixel grid
        same_grid = (
            input_map.data.shape[-2:] == self.data.shape[-2:]
            and np.allclose(input_map.center, self.center)
            and np.isclose(float(input_map.resolution), float(self.resolution), rtol=1e-3)
        )
        if same_grid:
            aligned = input_map
        else:
            aligned = self._replace(
                data=input_map.sampled_onto(self),
                weight=np.ones((input_map.n_stokes, input_map.n_nu, len(input_map.t), self.n_y, self.n_x), dtype=np.float32),
                stokes=input_map.stokes,
                nu=input_map.nu,
                units=input_map.units,
                **{input_map.axis3_label: input_map.t},
            )
        if aligned.units != self.units:
            aligned = aligned.to(self.units)

        s_idx = self.stokes.index(stokes) if isinstance(stokes, str) else int(stokes)
        nu_sel = range(self.n_nu)
        if slices and "nu" in slices:
            nu_sel = np.atleast_1d(np.asarray(slices["nu"])).ravel().tolist()
        curves = []
        k_ref = None
        for j in nu_sel:
            tf_j = compute_transfer_function(
                aligned, self, window=window, taper=taper, n_bins=n_bins,
                pad_factor=pad_factor, stokes_index=s_idx, nu_index=int(j) % self.n_nu,
                t_index=t_index,
            )
            curves.append(np.interp(tf_j.k, tf_j.k, tf_j.tf))
            k_ref = tf_j.k if k_ref is None or len(tf_j.k) < len(k_ref) else k_ref
        curves = [np.interp(k_ref, k_ref[: len(c)], c[: len(k_ref)]) if len(c) != len(k_ref) else c for c in curves]
        tf = np.stack(curves) if len(curves) > 1 else curves[0]
        beam = getattr(self, "_beam_fwhm", None)
        if beam is not None:
            beam = [beam[int(j) % len(beam)] for j in nu_sel]
        return TransferFunction(
            k=k_ref, tf=tf, input_map=input_map, output_map=self,
            nu=[self.nu[int(j) % self.n_nu] for j in nu_sel], beam_fwhm=beam,
        )

    def __repr__(self):
        base = super().__repr__()[:-1]
        return (
            base
            + f", center=({np.degrees(self.center[0]):.2f}°, {np.degrees(self.center[1]):.2f}°),"
            f" res={Quantity(self._res, 'rad')!r}, frame='{self.frame}')"
        )
