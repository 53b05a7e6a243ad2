"""Time-ordered data (reference: maria/tod/tod.py:34-470).

Fields are device (jnp) arrays of shape (n_det, n_time); the pointing is
kept factorized (boresight ⊗ static offsets, see sim/observation.py) and
full per-detector coordinates are only materialized on demand.
"""

from __future__ import annotations

import logging
import time as _time

import jax.numpy as jnp
import numpy as np

from ..coords import Coordinates
from ..coords.transforms import offsets_to_phi_theta_jit
from ..units import Quantity, parse_units
from ..utils import rotation_matrix_2d

logger = logging.getLogger("maria_tpu")

VALID_TOD_QUANTITIES = ["power", "rayleigh_jeans_temperature", "cmb_temperature_anisotropy", "brightness_temperature"]


class Pointing:
    """Factorized pointing: boresight tracks + detector offsets + the
    az/el -> ra/dec frame-rotation angle q(t)."""

    def __init__(self, boresight: Coordinates, offsets: np.ndarray, q: np.ndarray):
        self.boresight = boresight
        self.offsets = np.asarray(offsets)
        self.q = np.asarray(q)

    @property
    def t(self):
        return self.boresight.t

    @property
    def shape(self):
        return (len(self.offsets), len(self.t))

    def det_azel(self):
        """(az, el) jnp arrays of shape (n_det, n_t)."""
        pt = offsets_to_phi_theta_jit(
            jnp.asarray(self.offsets[:, None, :], dtype=jnp.float32),
            jnp.asarray(np.asarray(self.boresight.az), dtype=jnp.float32),
            jnp.asarray(np.asarray(self.boresight.el), dtype=jnp.float32),
        )
        return pt[..., 0], pt[..., 1]

    def offsets_radec(self):
        """Detector offsets in the ra/dec frame: R(q(t)) @ offsets, shape
        (n_det, n_t, 2)."""
        R = rotation_matrix_2d(self.q)  # (n_t, 2, 2)
        return np.einsum("tij,dj->dti", R, self.offsets)

    def det_radec(self):
        """(ra, dec) jnp arrays of shape (n_det, n_t)."""
        pt = offsets_to_phi_theta_jit(
            jnp.asarray(self.offsets_radec(), dtype=jnp.float32),
            jnp.asarray(np.asarray(self.boresight.ra), dtype=jnp.float32),
            jnp.asarray(np.asarray(self.boresight.dec), dtype=jnp.float32),
        )
        return pt[..., 0], pt[..., 1]

    def coordinates(self) -> Coordinates:
        """Materialized full Coordinates (parity API; memory-heavy)."""
        return self.boresight.broadcast(self.offsets, frame="az/el")

    def __getitem__(self, idx):
        return Pointing(self.boresight, self.offsets[idx], self.q)

    def time_subset(self, idx):
        """Pointing restricted to a time index/slice (frames recompute
        lazily on the sliced boresight)."""
        b = self.boresight
        nb = Coordinates(
            phi=np.asarray(b._phi)[idx], theta=np.asarray(b._theta)[idx],
            t=np.asarray(b.t)[idx], earth_location=b.earth_location,
            frame=b.frame.name,
        )
        return Pointing(nb, self.offsets, self.q[idx])


class TOD:
    def __init__(
        self,
        data: dict,
        pointing: Pointing = None,
        coords: Coordinates = None,
        weight=None,
        units: str = "K_RJ",
        dets=None,
        dtype=jnp.float32,
        metadata: dict = {},
        abscal: float = 1.0,
    ):
        self.pointing = pointing
        self._coords = coords
        self.dets = dets
        self.units = units
        self.dtype = dtype
        self.metadata = dict(metadata)
        self.abscal = abscal
        self.data = {k: jnp.asarray(v, dtype=dtype) for k, v in sorted(data.items())}
        self.weight = weight if weight is not None else jnp.ones(self.shape, dtype=dtype)

    # -- structure ---------------------------------------------------------------
    @property
    def fields(self):
        return sorted(self.data)

    @property
    def signal(self):
        total = 0
        for field in self.fields:
            total = total + self.data[field]
        return total

    @property
    def shape(self):
        return self.data[self.fields[0]].shape

    @property
    def time(self):
        return self.pointing.t if self.pointing is not None else None

    @property
    def duration(self):
        return float(np.ptp(self.time))

    @property
    def sample_rate(self):
        return Quantity(1 / float(np.mean(np.diff(self.time))), "Hz")

    @property
    def fs(self):
        return float(self.sample_rate.Hz)

    @property
    def coords(self) -> Coordinates:
        if self._coords is None:
            self._coords = self.pointing.coordinates()
        return self._coords

    @property
    def boresight(self):
        return self.pointing.boresight

    @property
    def el(self):
        _, el = self.pointing.det_azel()
        return np.asarray(el)

    @property
    def azim(self):
        return np.asarray(self.pointing.boresight.az)

    @property
    def elev(self):
        return np.asarray(self.pointing.boresight.el)

    def __getitem__(self, idx):
        """Detector (and optionally time) subset: `tod["f090"]`,
        `tod[mask]`, `tod[::2, :10000]` (reference tod.py:188-222,470)."""
        time_idx = None
        if isinstance(idx, tuple):
            if len(idx) > 2:
                raise IndexError(f"A TOD has 2 axes (det, time); got {len(idx)} indices.")
            idx, time_idx = (idx + (None,))[:2]
        if isinstance(idx, str):
            idx = self.dets.band_name == idx
        if isinstance(idx, slice):
            idx = np.arange(self.shape[0])[idx]
        idx = np.atleast_1d(idx)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        out = TOD(
            data={k: v[idx] for k, v in self.data.items()},
            pointing=self.pointing[idx] if self.pointing is not None else None,
            weight=self.weight[idx],
            units=self.units,
            # order-preserving: dets rows must stay aligned with data rows
            # for reversed/fancy indices
            dets=self.dets.take(idx) if self.dets is not None else None,
            metadata=self.metadata,
        )
        if time_idx is not None:
            if not isinstance(time_idx, slice):
                time_idx = np.atleast_1d(time_idx)
            out = TOD(
                data={k: v[:, time_idx] for k, v in out.data.items()},
                pointing=out.pointing.time_subset(time_idx) if out.pointing is not None else None,
                weight=out.weight[:, time_idx],
                units=out.units,
                dets=out.dets,
                metadata=out.metadata,
            )
        return out

    def get_field(self, field: str):
        """One simulated component, e.g. tod.get_field("atmosphere")
        (reference docs usage/tods)."""
        if field not in self.data:
            raise KeyError(f"No field '{field}' (available: {sorted(self.data)}).")
        return self.data[field]

    def subset(self, det_mask=None, time_range=None):
        out = self[det_mask] if det_mask is not None else self
        if time_range is not None:
            s, e = time_range
            out = TOD(
                data={k: v[..., s:e] for k, v in out.data.items()},
                pointing=out.pointing.time_subset(slice(s, e)) if out.pointing is not None else None,
                weight=out.weight[..., s:e],
                units=out.units,
                dets=out.dets,
                metadata=out.metadata,
            )
        return out

    # -- units ---------------------------------------------------------------------
    @property
    def spectrum(self):
        if not hasattr(self, "_spectrum"):
            if self.metadata.get("atmosphere"):
                from ..spectrum import AtmosphericSpectrum

                self._spectrum = AtmosphericSpectrum(self.metadata["region"])
            else:
                self._spectrum = None
        return self._spectrum

    def calibration_kwargs(self, band) -> dict:
        band_mask = self.dets.band_name == band.name
        kwargs = {"polarized": bool(~np.isnan(self.dets.gamma[band_mask]).all())}
        if self.metadata.get("atmosphere"):
            kwargs["spectrum"] = self.spectrum
            kwargs["zenith_pwv"] = self.metadata["pwv"]
            kwargs["base_temperature"] = self.metadata["base_temperature"]
            _, el = self.pointing.det_azel()
            kwargs["elevation"] = np.asarray(jnp.clip(el[band_mask], None, np.pi / 2))
        else:
            kwargs["spectrum"] = None
        return kwargs

    def to(self, units: str) -> "TOD":
        u = parse_units(units)
        if u.quantity not in VALID_TOD_QUANTITIES:
            raise ValueError(f"Cannot convert TOD to units '{units}' (quantity '{u.quantity}').")

        start_s = _time.monotonic()
        new_data = {field: jnp.array(v) for field, v in self.data.items()}
        for band in self.dets.bands:
            band_mask = np.where(self.dets.band_name == band.name)[0]
            if len(band_mask) == 0:
                continue
            cal = band.cal(f"{self.units} -> {units}", **self.calibration_kwargs(band))
            if cal.linear():
                # linear chains are a per-sample multiplicative factor;
                # evaluate on ones and scale on device
                factor = jnp.asarray(cal(np.ones(1, dtype=np.float32)), dtype=self.dtype)
                for field in self.fields:
                    new_data[field] = new_data[field].at[band_mask].set(
                        self.data[field][band_mask] * factor
                    )
            elif any(
                np.ndim(v) >= 1 and np.size(v) > 1
                for k, v in self.calibration_kwargs(band).items()
                if isinstance(v, (np.ndarray, jnp.ndarray))
            ):
                # per-sample kwargs (e.g. atmosphere-aware elevation):
                # the map is 2-D per sample, no 1-D table — host path
                for field in self.fields:
                    new_data[field] = new_data[field].at[band_mask].set(
                        jnp.asarray(cal(np.asarray(self.data[field][band_mask])), dtype=self.dtype)
                    )
            else:
                # elementwise nonlinear chains: never pull the (n_det,
                # n_t) array off device — evaluate the smooth radiometric
                # map on a 1025-point host table spanning the field's
                # range (two scalar reductions) and interpolate on device
                for field in self.fields:
                    d = self.data[field][band_mask]
                    lo = float(jnp.min(d))
                    hi = float(jnp.max(d))
                    span = max(hi - lo, 1e-9 * max(abs(hi), abs(lo), 1.0))
                    grid = np.linspace(lo - 0.01 * span, hi + 0.01 * span, 1025)
                    y_grid = np.asarray(cal(grid), dtype=float)
                    # interpolate in offset coordinates to keep f32 precision
                    y0 = y_grid[0]
                    new = jnp.interp(
                        (d - np.float32(grid[0])).astype(jnp.float32),
                        jnp.asarray(grid - grid[0], jnp.float32),
                        jnp.asarray(y_grid - y0, jnp.float32),
                    ) + np.float32(y0)
                    new_data[field] = new_data[field].at[band_mask].set(new.astype(self.dtype))
        logger.debug(f"Converted TOD to '{units}' in {_time.monotonic() - start_s:.2f} s")
        return TOD(
            data=new_data,
            pointing=self.pointing,
            weight=self.weight,
            units=units,
            dets=self.dets,
            metadata=self.metadata,
        )

    # -- splits ---------------------------------------------------------------------
    @property
    def turnarounds(self):
        import scipy as sp

        azim_grad = sp.ndimage.gaussian_filter(np.gradient(self.azim), sigma=16)
        return np.where(np.sign(azim_grad[:-1]) != np.sign(azim_grad[1:]))[0]

    def splits(self, target_split_time: float = None):
        turnarounds = self.turnarounds
        if len(turnarounds) < 2:
            turnarounds = np.array([0, self.shape[-1] - 1])
        if target_split_time is None:
            return list(zip(turnarounds[:-1], turnarounds[1:]))
        fs = self.fs
        out = []
        for s, e in zip(turnarounds[:-1], turnarounds[1:]):
            split_time = (e - s) / fs
            n_splits = int(np.ceil(split_time / target_split_time))
            n_samples = int(target_split_time * fs)
            for start in np.linspace(s, max(e - n_samples, s), n_splits).astype(int):
                out.append((start, min(start + n_samples, e)))
        return out

    # -- i/o --------------------------------------------------------------------
    def to_hdf(self, fname: str):
        """Full-fidelity HDF5 round trip: per-field data, weights, the
        factorized pointing (boresight + offsets + q), detector table and
        metadata. (The reference documents tod.to_hdf but ships it
        commented out, maria/tod/tod.py:361-363; this one works.)"""
        import json

        from ..utils import require

        h5py = require("h5py")
        with h5py.File(fname, "w") as f:
            g = f.create_group("data")
            for k, v in self.data.items():
                g.create_dataset(k, data=np.asarray(v))
            f.create_dataset("weight", data=np.asarray(self.weight))
            f.attrs["units"] = self.units
            f.attrs["metadata"] = json.dumps(self.metadata, default=float)
            if self.pointing is not None:
                b = self.pointing.boresight
                p = f.create_group("pointing")
                p.create_dataset("phi", data=np.asarray(b._phi))
                p.create_dataset("theta", data=np.asarray(b._theta))
                p.create_dataset("t", data=np.asarray(b.t))
                p.create_dataset("offsets", data=np.asarray(self.pointing.offsets))
                p.create_dataset("q", data=np.asarray(self.pointing.q))
                p.attrs["frame"] = b.frame.name
                p.attrs["lat_deg"] = b.earth_location.lat_deg
                p.attrs["lon_deg"] = b.earth_location.lon_deg
                p.attrs["height_m"] = b.earth_location.height_m
            if self.dets is not None:
                d = f.create_group("dets")
                d.attrs["table"] = self.dets.dets.to_json()
                d.attrs["name"] = self.dets.name
                d.attrs["bands"] = json.dumps(
                    [b.to_config() for b in self.dets.bands]
                    if hasattr(self.dets.bands[0], "to_config")
                    else [b.name for b in self.dets.bands]
                )

    @classmethod
    def from_hdf(cls, fname: str) -> "TOD":
        import json

        from ..band import BandList, parse_band
        from ..utils import require
        from ..utils.table import Table
        from ..coords.earth import EarthLocation

        h5py = require("h5py")
        with h5py.File(fname, "r") as f:
            data = {k: np.array(v) for k, v in f["data"].items()}
            weight = np.array(f["weight"])
            units = str(f.attrs["units"])
            metadata = json.loads(f.attrs["metadata"])
            pointing = None
            if "pointing" in f:
                p = f["pointing"]
                boresight = Coordinates(
                    phi=np.array(p["phi"]), theta=np.array(p["theta"]),
                    t=np.array(p["t"]),
                    earth_location=EarthLocation(
                        lat_deg=float(p.attrs["lat_deg"]),
                        lon_deg=float(p.attrs["lon_deg"]),
                        height_m=float(p.attrs["height_m"]),
                    ),
                    frame=str(p.attrs["frame"]),
                )
                pointing = Pointing(boresight, np.array(p["offsets"]), np.array(p["q"]))
            dets = None
            if "dets" in f:
                from ..array import Array

                table = Table.from_json(str(f["dets"].attrs["table"]))
                band_spec = json.loads(f["dets"].attrs["bands"])
                bands = BandList([parse_band(b) for b in band_spec])
                dets = Array(name=str(f["dets"].attrs["name"]), dets=table, bands=bands)
        return cls(
            data=data, pointing=pointing, weight=weight, units=units,
            dets=dets, metadata=metadata,
        )

    def to_fits(self, fname: str, format: str = "MUSTANG-2"):
        """Serialize in the MUSTANG-2 TOD format
        (reference: maria/tod/tod.py:291-359)."""
        if format.lower() not in ("mustang-2", "mustang2"):
            raise ValueError(f"Unsupported TOD format '{format}'.")
        from ..io.fits import write_fits_bintable

        ra, dec = self.pointing.det_radec()
        ra, dec = np.asarray(ra, dtype=np.float64), np.asarray(dec, dtype=np.float64)
        tod_rj = self.to("K_RJ") if self.units != "K_RJ" else self
        n_det, n_t = self.shape
        rel_t = np.broadcast_to(self.time - self.time[0], (n_det, n_t))
        pixid = np.broadcast_to(np.arange(n_det, dtype=np.int16)[:, None], (n_det, n_t))
        c_az, c_el = self.pointing.boresight.center(frame="az/el")
        jd_start = self.time[0] / 86400.0 + 2440587.5

        write_fits_bintable(
            fname,
            columns=[
                ("DX   ", "E", ra.ravel(), "radians"),
                ("DY   ", "E", dec.ravel(), "radians"),
                ("FNU  ", "E", np.asarray(tod_rj.signal).ravel(), "K_RJ"),
                ("UFNU ", "E", None, ""),
                ("TIME ", "E", rel_t.ravel(), "s"),
                ("COL  ", "I", None, ""),
                ("ROW  ", "I", None, ""),
                ("PIXID", "I", pixid.ravel(), ""),
                ("SCAN ", "I", None, ""),
                ("ELEV ", "E", None, ""),
            ],
            header_cards=[
                ("AZIM", float(np.asarray(c_az)), "radians"),
                ("ELEV", float(np.asarray(c_el)), "radians"),
                ("NDETS", n_det),
                ("JDSTART", jd_start),
                ("SITELAT", self.pointing.boresight.earth_location.lat_deg),
                ("SITELONG", self.pointing.boresight.earth_location.lon_deg),
                ("SITEELEV", self.pointing.boresight.earth_location.height_m),
            ],
        )

    @classmethod
    def from_fits(cls, fname: str, format: str = "MUSTANG-2", **kwargs) -> "TOD":
        if format.lower() in ("mustang-2", "mustang2"):
            return cls._from_mustang2(fname, **kwargs)
        raise ValueError(f"Unsupported TOD format '{format}'.")

    @classmethod
    def _from_mustang2(cls, fname: str, index: int = 1) -> "TOD":
        """(reference: maria/tod/tod.py:365-446)"""
        from ..array import Array
        from ..band import BandList, get_band
        from ..io.fits import read_fits
        from ..site import get_site
        from ..utils.table import Table

        hdus = read_fits(fname)
        header, raw = hdus[index]

        det_uids, det_counts = np.unique(raw["PIXID"], return_counts=True)
        if det_counts.std() > 0:
            raise ValueError("Cannot reshape a ragged TOD.")
        n_det, n_t = len(det_uids), int(det_counts.max())

        signal = raw["FNU"].astype(np.float32).reshape(n_det, n_t)
        ra = raw["DX"].astype(float).reshape(n_det, n_t)
        dec = raw["DY"].astype(float).reshape(n_det, n_t)
        t = raw["TIME"].astype(float).reshape(n_det, n_t).mean(axis=0)
        if "JDSTART" in header:
            t = t + (header["JDSTART"] - 2440587.5) * 86400.0

        site = get_site("GBT")
        boresight = Coordinates(
            phi=ra.mean(axis=0), theta=dec.mean(axis=0), t=t,
            earth_location=site.earth_location, frame="ra/dec",
        )
        # detector offsets from the first sample's spread (ra/dec frame)
        offsets = np.stack(
            [-(ra[:, 0] - ra[:, 0].mean()) * np.cos(dec[:, 0].mean()), dec[:, 0] - dec[:, 0].mean()],
            axis=-1,
        )

        band = get_band("m2/f093")
        dets = Table(
            {
                "base_det_index": np.arange(n_det),
                "xi": offsets[:, 0],
                "eta": offsets[:, 1],
                "baseline_x": 0.0, "baseline_y": 0.0, "baseline_z": 0.0,
                "gamma": np.nan, "pol_label": "none",
                "primary_size": 100.0, "bath_temp": 0.3,
                "band_name": band.name,
            }
        )
        array = Array(name="mustang2", dets=dets, bands=BandList([band]))
        metadata = {
            "atmosphere": False,
            "altitude": float(site.altitude.m),
            "region": site.region,
            "real_obs": True,
            "base_temperature": header.get("TAMBIENT"),
        }
        pointing = Pointing(boresight, offsets, q=np.zeros(n_t))
        return cls(
            data={"signal": signal}, pointing=pointing, dets=array,
            units="K_RJ", metadata=metadata,
        )

    def process(self, **kwargs) -> "TOD":
        from .processing import process_tod

        return process_tod(self, **kwargs)

    def plot(self, **kwargs):
        from ..plotting import plot_tod

        return plot_tod(self, **kwargs)

    def __repr__(self):
        sig = np.asarray(self.signal)
        return (
            f"TOD(shape={self.shape}, fields={self.fields}, units='{self.units}', "
            f"signal_rms={Quantity(float(sig.std()), self.units)!r})"
        )
