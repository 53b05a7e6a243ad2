"""Detector arrays (reference: maria/array/array.py:111-660).

An Array is a column table of per-detector properties (focal-plane
offsets xi/eta, polarization angle gamma, band, aperture, baselines) plus
its BandList. The table is host-side; the sim engine extracts static jnp
arrays (offsets, Mueller weights, band masks) from it at program-build
time.
"""

from __future__ import annotations

import glob
import logging
import os
import uuid

import numpy as np

from ..band import Band, BandList, parse_band
from ..beam import compute_angular_fwhm
from ..io import flatten_config, read_json
from ..units import Angle, Quantity
from ..utils import compute_diameter
from ..utils.table import Table, concat, read_csv
from .generation import PACKINGS, SHAPES, generate_2d_pattern  # noqa: F401

here = os.path.dirname(__file__)
logger = logging.getLogger("maria_tpu")

ARRAY_CONFIGS = {}
for path in sorted(glob.glob(f"{here}/configs/*.json")):
    key = os.path.splitext(os.path.basename(path))[0]
    ARRAY_CONFIGS[key] = read_json(path)
ARRAY_CONFIGS = flatten_config(ARRAY_CONFIGS)

all_arrays = sorted(ARRAY_CONFIGS)

DET_COLUMNS = [
    "array_name", "base_det_index", "band_name", "xi", "eta",
    "baseline_x", "baseline_y", "baseline_z", "gamma", "pol_label",
    "primary_size", "bath_temp", "time_constant",
]

# dtype of every per-detector table column (reference: array/array.py:66-85)
DET_COLUMN_TYPES = {
    "array_name": str, "uid": str, "base_det_index": int, "band_name": str,
    "band_center": float, "xi": float, "eta": float,
    "baseline_x": float, "baseline_y": float, "baseline_z": float,
    "gamma": float, "pol_label": str, "primary_size": float,
    "bath_temp": float, "time_constant": float, "efficiency": float,
}

# kwargs that may be given per detector as arrays (reference: array/array.py:28)
PER_DET_KWARGS = ["xi", "eta", "baseline_x", "baseline_y", "baseline_z", "gamma", "pol_label", "band"]

# every kwarg Array.from_config understands (reference: array/array.py:40)
ALLOWED_ARRAY_KWARGS = [
    "band", "bands", "max_baseline", "baseline_offset", "beam_spacing",
    "field_of_view", "focal_plane_offset", "n", "array_offset", "packing",
    "polarization", "primary_size", "shape", "bath_temp", "file", *PER_DET_KWARGS,
]


def get_array(key: str, **kwargs) -> "Array":
    if key not in ARRAY_CONFIGS:
        from ..errors import InvalidArrayError

        raise InvalidArrayError(key, valid=all_arrays)
    return Array.from_config({"name": key, **ARRAY_CONFIGS[key], **kwargs})


class Array:
    def __init__(self, name: str, dets: Table, bands: BandList):
        self.name = name
        self.dets = dets.reset_index(drop=True)
        self.dets["array_name"] = name
        self.bands = BandList([b for b in bands if b.name in set(self.dets.band_name)])

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_config(cls, config: dict) -> "Array":
        c = dict(config)
        degrees = c.pop("degrees", True)
        name = c.pop("name", str(uuid.uuid4())[:8])
        c.pop("description", None)

        # the reference docs' explicit-detector spellings
        # (usage/inputs/instruments/arrays/custom.rst): sky_x/sky_y are
        # focal-plane offsets, pol_angle is the polarization angle
        for alias, canonical in (("sky_x", "xi"), ("sky_y", "eta"), ("pol_angle", "gamma")):
            if alias in c:
                c.setdefault(canonical, c.pop(alias))

        # CSV detector tables: columns become per-detector kwargs
        # (reference array/array.py:326-334); paths resolve against the
        # package's array directory first, then the filesystem
        if "file" in c:
            file = c.pop("file")
            packaged = os.path.join(here, file)
            path = packaged if os.path.exists(packaged) else file
            table = read_csv(path)
            for col in table.columns:
                if col not in ("pad", "det_index") and not col.startswith("Unnamed"):
                    c.setdefault(col, table[col])

        bands = BandList([parse_band(b) for b in c.pop("bands")]) if "bands" in c else None
        if bands is None and "band" in c:
            bands = BandList([parse_band(c.pop("band"))])
        if bands is None:
            raise ValueError("Missing array parameter 'bands'.")

        primary_size = c.pop("primary_size", None)
        if primary_size is None:
            raise ValueError("Missing array parameter 'primary_size'.")

        if degrees:
            for param in ("xi", "eta", "field_of_view", "gamma", "rotation"):
                if param in c:
                    c[param] = np.radians(np.asarray(c[param], dtype=float))

        baselines = {
            k: np.atleast_1d(np.asarray(c.pop(k), dtype=float))
            for k in ("baseline_x", "baseline_y", "baseline_z")
            if k in c
        }
        # explicit per-detector band assignment (reference PER_DET_KWARGS,
        # array/array.py:28-37): detectors are NOT replicated per band
        det_band_names = c.pop("band_name", None)
        if det_band_names is not None:
            det_band_names = np.atleast_1d(np.asarray(det_band_names, dtype=object))
            unknown = set(det_band_names) - {b.name for b in bands}
            if unknown:
                raise ValueError(
                    f"band_name values {sorted(unknown)} are not in bands "
                    f"{[b.name for b in bands]}."
                )
            n_given = (
                len(np.atleast_1d(c["xi"])) if "xi" in c
                else len(next(iter(baselines.values()))) if baselines
                else None
            )
            if n_given is not None and len(det_band_names) != n_given:
                raise ValueError(
                    f"band_name has {len(det_band_names)} entries for {n_given} detectors."
                )

        if "xi" in c and "eta" in c:
            offsets = np.stack(
                [np.atleast_1d(c.pop("xi")), np.atleast_1d(c.pop("eta"))], axis=-1
            )
        elif baselines:
            # baseline-only tables (interferometer pads): co-pointed
            # antennas, zero focal-plane offsets
            offsets = np.zeros((len(next(iter(baselines.values()))), 2))
        else:
            max_resolution = max(
                compute_angular_fwhm(primary_size, z=np.inf, nu=band.center) for band in bands
            )
            pattern_kwargs = {}
            if c.get("n") is not None:
                pattern_kwargs["n"] = int(c.pop("n"))
                if pattern_kwargs["n"] == 1:
                    pattern_kwargs["spacing"] = 0.0
            if "field_of_view" in c:
                pattern_kwargs["max_diameter"] = float(c.pop("field_of_view"))
            if "beam_spacing" in c and "max_diameter" in pattern_kwargs and "n" not in pattern_kwargs:
                pattern_kwargs["spacing"] = float(c.pop("beam_spacing")) * max_resolution
            elif "beam_spacing" in c and "n" in pattern_kwargs and "max_diameter" not in pattern_kwargs:
                pattern_kwargs["spacing"] = float(c.pop("beam_spacing")) * max_resolution
            else:
                c.pop("beam_spacing", None)
            if "n" not in pattern_kwargs and "spacing" not in pattern_kwargs:
                pattern_kwargs["spacing"] = 1.5 * max_resolution
            offsets = generate_2d_pattern(
                **pattern_kwargs,
                shape=c.pop("shape", "hexagon"),
                packing=c.pop("packing", "triangular"),
                rotation=float(c.pop("rotation", 0.0)),
            )

        n = len(offsets)
        dets = Table(
            {
                "base_det_index": np.arange(n),
                "xi": offsets[:, 0],
                "eta": offsets[:, 1],
                "baseline_x": baselines.get("baseline_x", np.zeros(n)),
                "baseline_y": baselines.get("baseline_y", np.zeros(n)),
                "baseline_z": baselines.get("baseline_z", np.zeros(n)),
                "primary_size": float(np.mean(primary_size)) * np.ones(n),
                "bath_temp": float(c.pop("bath_temp", 0.0)) * np.ones(n),
            }
        )

        focal_plane_offset = c.pop("focal_plane_offset", (0.0, 0.0))
        dets["xi"] += np.radians(focal_plane_offset[0])
        dets["eta"] += np.radians(focal_plane_offset[1])

        # polarization doubles detectors with orthogonal gammas
        # (reference: array/array.py:481-491)
        if "gamma" in c:
            dets["gamma"] = np.broadcast_to(c.pop("gamma"), (n,))
            dets["pol_label"] = "A"
        elif c.pop("polarized", False):
            rng = np.random.default_rng(int.from_bytes(name.encode()[:4].ljust(4, b"x"), "little"))
            dets["gamma"] = rng.uniform(0, np.pi, size=n)
            dets["pol_label"] = "A"
            other = dets.copy()
            other["gamma"] = (dets.gamma + np.pi / 2) % np.pi
            other["pol_label"] = "B"
            dets = concat([dets, other])
        else:
            dets["gamma"] = np.nan
            dets["pol_label"] = "none"

        if det_band_names is not None:
            # explicit assignment: one row per detector as supplied
            # (polarization doubling above already duplicated rows, so
            # tile the names to match)
            reps = len(dets) // len(det_band_names)
            dets["band_name"] = np.tile(det_band_names, reps)
            tc = {b.name: b.time_constant for b in bands}
            dets["time_constant"] = [tc[n] for n in dets.band_name]
        else:
            # per-band replication (reference: array/array.py:496-502)
            band_dets = []
            for band in bands:
                bd = dets.copy()
                bd["band_name"] = band.name
                bd["time_constant"] = band.time_constant
                band_dets.append(bd)
            dets = concat(band_dets)
        dets = dets.sort_values(["band_name", "base_det_index"], ignore_index=True)
        return cls(name=name, dets=dets, bands=bands)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "Array":
        return cls.from_config(kwargs)

    # -- structure ---------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.dets)

    def __len__(self):
        return self.n

    def __getattr__(self, attr):
        dets = self.__dict__.get("dets")
        if dets is not None and attr in dets.columns:
            return dets[attr]
        raise AttributeError(attr)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.mask(band_name=key)
        return Array(name=self.name, dets=self.dets.iloc[np.atleast_1d(key)] if np.ndim(key) else self.dets.iloc[[key]], bands=self.bands)

    def subset(self, mask) -> "Array":
        return Array(name=self.name, dets=self.dets.loc[np.asarray(mask)], bands=self.bands)

    def take(self, idx) -> "Array":
        """Row selection preserving ORDER and duplicates (unlike the
        boolean-mask `subset`) — the detector-axis analogue of fancy
        indexing, used by TOD slicing."""
        idx = np.asarray(idx)
        return Array(
            name=self.name,
            dets=self.dets.iloc[idx].reset_index(drop=True),
            bands=self.bands,
        )

    def mask(self, **kwargs) -> np.ndarray:
        mask = np.ones(self.n, dtype=bool)
        for key, value in kwargs.items():
            mask &= self.dets[key] == value
        return mask

    def one_detector_from_each_band(self) -> "Array":
        index = [int(np.argmax(self.band_name == band.name)) for band in self.bands]
        return Array(name=self.name, dets=self.dets.iloc[index], bands=self.bands)

    def outer(self) -> "Array":
        """The convex-hull subset of detectors (reference: array.py:156)."""
        import scipy as sp

        offsets = self.offsets
        if len(offsets) < 4 or compute_diameter(offsets) == 0:
            return self
        hull = sp.spatial.ConvexHull(offsets)
        return Array(name=self.name, dets=self.dets.iloc[hull.vertices], bands=self.bands)

    # -- physics ----------------------------------------------------------------
    @property
    def offsets(self) -> np.ndarray:
        return np.stack([self.dets.xi, self.dets.eta], axis=-1)

    @property
    def field_of_view(self) -> Angle:
        return Angle(compute_diameter(self.offsets), "rad")

    @property
    def max_baseline(self) -> float:
        return compute_diameter(
            np.stack([self.baseline_x, self.baseline_y, self.baseline_z], axis=-1)
        )

    @property
    def band_center(self) -> np.ndarray:
        values = np.zeros(self.n)
        for band in self.bands:
            values[self.band_name == band.name] = band.center
        return values

    def _per_det_band_attr(self, attr: str) -> np.ndarray:
        values = np.zeros(self.n)
        for band in self.bands:
            values[self.band_name == band.name] = getattr(band, attr)
        return values

    @property
    def gain_error(self) -> np.ndarray:
        return self._per_det_band_attr("gain_error")

    @property
    def knee(self) -> np.ndarray:
        return self._per_det_band_attr("knee")

    @property
    def efficiency(self) -> np.ndarray:
        return self._per_det_band_attr("efficiency")

    def mueller(self) -> np.ndarray:
        """Per-detector Mueller matrices from gamma
        (reference: array/array.py:204-218); NaN gamma = unpolarized."""
        a = self.gamma
        m = np.stack(
            [
                np.where(np.isnan(a), np.sqrt(2), 1),
                np.where(np.isnan(a), 0, np.cos(2 * a)),
                np.where(np.isnan(a), 0, np.sin(2 * a)),
                np.zeros_like(a),
            ],
            axis=1,
        )
        return 0.5 * m[..., None] * m[..., None, :]

    def stokes_weight(self) -> np.ndarray:
        return self.mueller()[:, 0]

    def angular_fwhm(self, z=np.inf) -> Quantity:
        return Quantity(
            compute_angular_fwhm(z=z, fwhm_0=self.primary_size, n=1, nu=self.band_center), "rad"
        )

    def physical_fwhm(self, z) -> Quantity:
        return Quantity(np.asarray(z) * self.angular_fwhm(z).rad, "m")

    def passband(self, nu) -> np.ndarray:
        nu = np.atleast_1d(nu)
        out = np.zeros((self.n, len(nu)))
        for band in self.bands:
            out[self.band_name == band.name] = band.passband(nu)
        return out

    def plot(self, ax=None):
        """Focal-plane layout colored by band (reference array.py:520+)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(1, 1, figsize=(5, 5))
        for band in self.bands:
            mask = self.band_name == band.name
            fwhm = np.degrees(np.nanmean(self.angular_fwhm(np.inf).rad[mask]))
            offsets = np.degrees(self.offsets[mask])
            ax.scatter(offsets[:, 0], offsets[:, 1], s=max(fwhm * 100, 4), label=band.name, alpha=0.6)
        ax.set_xlabel(r"$\xi$ [deg]")
        ax.set_ylabel(r"$\eta$ [deg]")
        ax.set_aspect("equal")
        ax.legend(fontsize=7)
        return ax

    def __repr__(self):
        return (
            f"Array({self.name}: n={self.n}, bands={self.bands.names}, "
            f"fov={self.field_of_view!r})"
        )


class ArrayList:
    """Concatenating façade over multiple arrays
    (reference: maria/array/array.py:609-660)."""

    def __init__(self, arrays):
        if isinstance(arrays, ArrayList):
            arrays = arrays.arrays
        if isinstance(arrays, Array):
            arrays = [arrays]
        if isinstance(arrays, dict):
            arrays = [
                Array.from_config({"name": name, **cfg}) if not isinstance(cfg, Array) else cfg
                for name, cfg in arrays.items()
            ]
        self.arrays = list(arrays)

    def combine(self) -> Array:
        dets = concat([a.dets for a in self.arrays])
        bands = []
        seen = set()
        for a in self.arrays:
            for band in a.bands:
                if band.name not in seen:
                    bands.append(band)
                    seen.add(band.name)
        name = "+".join(a.name for a in self.arrays)
        combined = Array(name=name, dets=dets, bands=BandList(bands))
        combined.dets["array_name"] = np.concatenate(
            [np.full(a.n, a.name) for a in self.arrays]
        )
        return combined

    def __iter__(self):
        return iter(self.arrays)

    def __len__(self):
        return len(self.arrays)

    def __getitem__(self, i):
        return self.arrays[i]

    def __repr__(self):
        return f"ArrayList({[a.name for a in self.arrays]})"


def get_array_config(key: str = None, **kwargs) -> dict:
    """Raw config dict for a named array, with keyword overrides
    (reference maria/array/array.py:97-104)."""
    c = {}
    if key:
        if key not in ARRAY_CONFIGS:
            from ..errors import InvalidArrayError

            raise InvalidArrayError(key, valid=all_arrays)
        c = {"name": key, **ARRAY_CONFIGS[key]}
    c.update(kwargs)
    return c
