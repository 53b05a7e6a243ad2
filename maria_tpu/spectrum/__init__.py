"""Atmospheric spectra: emission, opacity and path delay lookup
(reference: maria/spectrum/atmosphere.py:17-142).

Grids are fetched from the data cache or generated offline by
`spectrum.synth`; lookups are pure-jnp multilinear interpolations that
fuse into the simulation program.
"""

from __future__ import annotations

import logging
import os
import tempfile

import numpy as np

from ..errors import InvalidRegionError
from ..io import fetch, register_generator
from ..ops import RegularGridInterpolator
from ..site.regions import all_regions, region_entry
from ..units import Quantity
from . import synth

logger = logging.getLogger("maria_tpu")

SPECTRUM_SOURCE = "synthetic/v1"


def _generate_spectrum_file(source_path: str, destination: str):
    """Offline generator registered with the io cache."""
    region = os.path.splitext(os.path.basename(source_path))[0]
    if region not in all_regions:
        raise InvalidRegionError(region, valid=all_regions)
    altitude = float(region_entry(region).altitude)
    logger.info(f"Generating synthetic atmospheric spectrum for region '{region}' (~10 s, cached)...")
    grids = synth.generate_spectrum_grids(base_altitude_m=altitude)
    # a private temporary file, then an atomic rename: concurrent
    # processes generating the same region never see a partial file
    with tempfile.NamedTemporaryFile(dir=os.path.dirname(destination), suffix=".npz", delete=False) as f:
        np.savez_compressed(f, **grids)
    os.replace(f.name, destination)


register_generator("atmosphere/spectra/synthetic/", _generate_spectrum_file)


class AtmosphericSpectrum:
    """Emission/opacity/path-delay lookup over
    (base_temperature, zenith_pwv, elevation, nu)."""

    def __init__(self, region: str, altitude: float = None, source: str = SPECTRUM_SOURCE, refresh_cache: bool = False):
        if region not in all_regions:
            raise InvalidRegionError(region, valid=all_regions)
        self.region = region
        self.altitude = altitude or float(region_entry(region).altitude)
        self.source = source

        self.cache_path = fetch(
            f"atmosphere/spectra/{source}/{region}.npz",
            max_age=365 * 86400,
            refresh=refresh_cache,
        )

        with np.load(self.cache_path) as f:
            self.side_base_temperature = f["side_base_temperature_K"][:].astype(float)
            self.side_zenith_pwv = f["side_zenith_pwv_mm"][:].astype(float)
            self.side_elevation = f["side_elevation_rad"][:].astype(float)
            self.side_nu = f["side_nu_Hz"][:].astype(float)
            self._emission = f["rayleigh_jeans_temperature_K"][:]
            self._opacity = f["opacity_nepers"][:]
            self._path_delay = f["excess_path_m"][:]

        self._interpolators = {}

    @property
    def points(self):
        return (
            self.side_base_temperature,
            self.side_zenith_pwv,
            self.side_elevation,
            self.side_nu,
        )

    @property
    def nu_min(self):
        return Quantity(self.side_nu.min(), "Hz")

    @property
    def nu_max(self):
        return Quantity(self.side_nu.max(), "Hz")

    def _interp(self, quantity, nu, pwv=None, base_temperature=None, elevation=None):
        pwv = pwv if pwv is not None else np.median(self.side_zenith_pwv)
        base_temperature = (
            base_temperature if base_temperature is not None else np.median(self.side_base_temperature)
        )
        elevation = elevation if elevation is not None else np.radians(45.0)
        if quantity not in self._interpolators:
            self._interpolators[quantity] = RegularGridInterpolator(
                self.points, getattr(self, f"_{quantity}")
            )
        return np.asarray(
            self._interpolators[quantity]((base_temperature, pwv, elevation, nu))
        )

    def emission(self, nu, pwv=None, base_temperature=None, elevation=None):
        return self._interp("emission", nu, pwv, base_temperature, elevation)

    def opacity(self, nu, pwv=None, base_temperature=None, elevation=None):
        return self._interp("opacity", nu, pwv, base_temperature, elevation)

    def path_delay(self, nu, pwv=None, base_temperature=None, elevation=None):
        return self._interp("path_delay", nu, pwv, base_temperature, elevation)

    def transmission(self, nu, pwv=None, base_temperature=None, elevation=None):
        return np.exp(-self.opacity(nu, pwv, base_temperature, elevation))

    def __repr__(self):
        return (
            f"AtmosphericSpectrum({self.nu_min} - {self.nu_max}):\n"
            f"  region: {self.region}\n"
            f"  altitude: {Quantity(self.altitude, 'm')}"
        )
