"""Spectral passbands (reference: maria/band/band.py:86-338).

A Band owns its passband table tau(nu), its noise spec (NEP / NET_RJ /
NET_CMB interconverted through the calibration graph), and device-side
bandpass-integration tables: `atmosphere_power` pre-integrates
emission x passband over nu on the host once, and at runtime the lookup
is a fused jnp bilinear interpolation over (pwv, elevation).
"""

from __future__ import annotations

import glob
import logging
import os
from collections.abc import Mapping

import jax.numpy as jnp
import numpy as np

from ..calibration import Calibration
from ..constants import MAX_NU_HZ, MIN_NU_HZ, c, k_B
from ..errors import FrequencyOutOfBoundsError
from ..io import flatten_config, read_json
from ..ops import RegularGridInterpolator
from ..units import Quantity

here = os.path.dirname(__file__)
logger = logging.getLogger("maria_tpu")

BAND_CONFIGS = {}
for path in sorted(glob.glob(f"{here}/configs/*.json")):
    tag = os.path.splitext(os.path.basename(path))[0]
    BAND_CONFIGS[tag] = read_json(path)
BAND_CONFIGS = flatten_config(BAND_CONFIGS)

# units/dtype of the displayable Band fields (reference: band/format.csv)
BAND_FIELD_FORMATS = {
    "name": {"units": "none", "dtype": "str"},
    "center": {"units": "Hz", "dtype": "float"},
    "width": {"units": "Hz", "dtype": "float"},
    "shape": {"units": "none", "dtype": "str"},
    "efficiency": {"units": "none", "dtype": "float"},
    "NEP": {"units": "W√s", "dtype": "float"},
    "NET_RJ": {"units": "K√s", "dtype": "float"},
    "NET_CMB": {"units": "K√s", "dtype": "float"},
}

all_bands = sorted(BAND_CONFIGS)


def parse_band(band):
    if isinstance(band, Band):
        return band
    if isinstance(band, Mapping):
        return Band(**band)
    if isinstance(band, str):
        return get_band(band)
    raise ValueError(f"Cannot parse band {band!r}.")


def get_band(band_name: str) -> "Band":
    if band_name in BAND_CONFIGS:
        return Band(name=band_name, **BAND_CONFIGS[band_name])
    raise ValueError(f"'{band_name}' is not a valid pre-defined band name. See maria_tpu.all_bands.")


def generate_passband(center, width, shape, samples=256):
    """(reference: band/band.py:61-83)"""
    if shape == "flat":
        nu_min, nu_max = center - 0.6 * width, center + 0.6 * width
    elif shape == "top_hat":
        nu_min, nu_max = center - width, center + width
    else:
        nu_min, nu_max = center - 1.5 * width, center + 1.5 * width

    nu = np.linspace(nu_min, nu_max, samples)
    if shape == "flat":
        tau = np.where((nu > center - 0.5 * width) & (nu < center + 0.5 * width), 1.0, 0.0)
    elif shape == "gaussian":
        tau = np.exp(np.log(0.5) * (2 * (nu - center) / width) ** 2)
    elif shape == "top_hat":
        tau = np.exp(np.log(0.5) * (2 * (nu - center) / width) ** 8)
    else:
        raise ValueError(f"Invalid passband shape '{shape}'.")
    return nu, tau


class Band:
    def __init__(
        self,
        center: float = None,
        width: float = None,
        nu=None,
        tau=None,
        name: str = None,
        shape: str = "gaussian",
        efficiency: float = 0.5,
        sensitivity: float = None,
        NET_RJ: float = None,
        NET_CMB: float = None,
        NEP: float = None,
        NEP_per_loading: float = 0.0,
        gain_error: float = 0,
        knee: float = 1.0,
        time_constant: float = 0.0,
        spectrum_kwargs: dict = {},
    ):
        auto = center is not None and width is not None
        manual = nu is not None and tau is not None
        if not auto ^ manual:
            raise ValueError("Pass either both 'center' and 'width' or both 'nu' and 'tau'.")

        if auto:
            self.nu, self.tau = generate_passband(center, width, shape, samples=1024)
        else:
            tau = np.asarray(tau, dtype=float)
            tau_max = tau.max()
            efficiency *= tau_max
            self.nu = np.asarray(nu, dtype=float)
            self.tau = tau / tau_max
            if self.nu.shape != self.tau.shape or self.nu.ndim != 1:
                raise ValueError(f"'nu' and 'tau' have mismatched shapes ({self.nu.shape}, {self.tau.shape}).")

        if (self.nu < MIN_NU_HZ).any() or (self.nu > MAX_NU_HZ).any():
            if nu is None:
                raise FrequencyOutOfBoundsError(center_and_width=(center, width))
            raise FrequencyOutOfBoundsError(nu=self.nu[(self.nu < MIN_NU_HZ) | (self.nu > MAX_NU_HZ)])

        # e.g. 150 GHz -> "f150"
        self.name = name or f"f{10 ** (np.log10(self.center) % 3):>03.0f}"
        self.shape = shape
        self.efficiency = efficiency
        self.NEP_per_loading = NEP_per_loading
        self.knee = knee
        self.time_constant = time_constant
        self.gain_error = gain_error

        self.spectrum = None
        self.spectrum_kwargs = {}
        if spectrum_kwargs:
            from ..spectrum import AtmosphericSpectrum

            self.spectrum = AtmosphericSpectrum(region=spectrum_kwargs["region"])
            self.spectrum_kwargs = {
                "zenith_pwv": spectrum_kwargs.get("pwv", 1.0),
                "base_temperature": spectrum_kwargs.get(
                    "temperature", float(np.mean(self.spectrum.side_base_temperature))
                ),
                "elevation": np.radians(spectrum_kwargs.get("elevation", 45)),
            }

        if sensitivity is not None:
            logger.warning("'sensitivity' is deprecated; use 'NET_RJ' or 'NET_CMB'.")
            NET_RJ = sensitivity

        if NEP is not None:
            self.NEP = float(NEP)
        elif NET_RJ is not None:
            self.NET_RJ = NET_RJ
        elif NET_CMB is not None:
            self.NET_CMB = NET_CMB
        else:
            logger.warning(f"No noise level specified for band {self.name}; assuming 50 uK_RJ√s.")
            self.NET_RJ = 50e-6

    # -- derived spectral properties ------------------------------------------
    def to_config(self) -> dict:
        """Reconstruction dict: Band(**band.to_config()) round-trips the
        explicit passband and noise/readout parameters."""
        return {
            "name": self.name,
            "nu": np.asarray(self.nu, dtype=float).tolist(),
            "tau": np.asarray(self.tau, dtype=float).tolist(),
            "efficiency": float(self.efficiency),
            "NEP": float(self.NEP),
            "NEP_per_loading": float(self.NEP_per_loading),
            "gain_error": float(self.gain_error),
            "knee": float(self.knee),
            "time_constant": float(self.time_constant),
        }

    @property
    def center(self) -> float:
        """Band center in Hz (tau-weighted mean)."""
        return float(np.round(np.sum(self.nu * self.tau) / np.sum(self.tau), 2))

    @property
    def width(self) -> float:
        """Full width at half maximum of the passband, in Hz."""
        crossings = np.where((self.tau[1:] > 0.5) != (self.tau[:-1] > 0.5))[0]
        nus = [
            np.interp(0.5, self.tau[[i, i + 1]][np.argsort(self.tau[[i, i + 1]])],
                      self.nu[[i, i + 1]][np.argsort(self.tau[[i, i + 1]])])
            for i in crossings
        ]
        return float(np.ptp(nus)) if len(nus) > 1 else float(np.ptp(self.nu))

    @property
    def wavelength(self) -> float:
        return c / self.center

    def passband(self, nu):
        """Interpolated (Rayleigh-Jeans) response at frequencies nu [Hz]."""
        return self.efficiency * np.interp(np.asarray(nu, dtype=float), self.nu, self.tau, left=0, right=0)

    # -- noise spec -------------------------------------------------------------
    def cal(self, signature: str, **kwargs) -> Calibration:
        return Calibration(signature, band=self, **kwargs)

    @property
    def NET_RJ(self):
        return float(self.cal("W -> K_RJ", spectrum=self.spectrum, **self.spectrum_kwargs)(self.NEP))

    @NET_RJ.setter
    def NET_RJ(self, value):
        self.NEP = float(self.cal("K_RJ -> W", spectrum=self.spectrum, **self.spectrum_kwargs)(value))

    @property
    def NET_CMB(self):
        return float(self.cal("W -> K_CMB", spectrum=self.spectrum, **self.spectrum_kwargs)(self.NEP))

    @NET_CMB.setter
    def NET_CMB(self, value):
        self.NEP = float(self.cal("K_CMB -> W", spectrum=self.spectrum, **self.spectrum_kwargs)(value))

    # -- bandpass integrals ------------------------------------------------------
    def compute_transmission_integral(self, spectrum=None, nu_min_Hz=0.0, nu_max_Hz=np.inf, **kwargs):
        """∫ tau(nu) e^-opacity dnu — the K_RJ <-> W kernel
        (reference: band/band.py:235-255)."""
        if spectrum is None:
            nu = self.nu[(self.nu >= nu_min_Hz) & (self.nu < nu_max_Hz)]
            return float(np.trapezoid(self.passband(nu), x=nu))
        mask = (spectrum.side_nu >= nu_min_Hz) & (spectrum.side_nu < nu_max_Hz)
        nu = spectrum.side_nu[mask]
        grid = np.trapezoid(
            self.passband(nu) * np.exp(-spectrum._opacity[..., mask]), x=nu, axis=-1
        )
        interp = RegularGridInterpolator(spectrum.points[:3], grid)
        xi = (kwargs["base_temperature"], kwargs["zenith_pwv"], kwargs["elevation"])
        return np.asarray(interp(xi))

    def atmosphere_power_table(self, spectrum, base_temperature: float):
        """Host-precomputed (pwv, elevation) -> loading power [pW] grid for
        this band at a fixed base temperature. The device-side lookup is a
        bilinear interpolation (reference hot path: band/band.py:264-300)."""
        values = 1e12 * k_B * np.trapezoid(
            spectrum._emission * self.passband(spectrum.side_nu), spectrum.side_nu, axis=-1
        )  # (T_base, pwv, el)
        T_sides = spectrum.side_base_temperature
        i = int(np.clip(np.searchsorted(T_sides, base_temperature) - 1, 0, len(T_sides) - 2))
        w = np.clip((base_temperature - T_sides[i]) / (T_sides[i + 1] - T_sides[i]), 0, 1)
        table = (1 - w) * values[i] + w * values[i + 1]  # (pwv, el)
        return (
            jnp.asarray(spectrum.side_zenith_pwv),
            jnp.asarray(spectrum.side_elevation),
            jnp.asarray(table),
        )

    def atmosphere_power(self, spectrum, base_temperature, zenith_pwv, elevation, method="linear"):
        """Band-integrated atmospheric loading [pW] at (pwv, el) samples."""
        pwv_side, el_side, table = self.atmosphere_power_table(spectrum, float(np.mean(base_temperature)))
        return np.asarray(RegularGridInterpolator((pwv_side, el_side), table)((zenith_pwv, elevation)))

    def transmission(self, region="chajnantor", pwv=1.0, elevation=np.radians(90)):
        from ..spectrum import AtmosphericSpectrum

        if self.spectrum is None or self.spectrum.region != region:
            self.spectrum = AtmosphericSpectrum(region=region)
        return self.spectrum.transmission(nu=self.center, pwv=pwv, elevation=elevation)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "center": Quantity(self.center, "Hz"),
            "width": Quantity(self.width, "Hz"),
            "efficiency": self.efficiency,
            "NEP": Quantity(self.NEP, "W√s"),
            "NET_RJ": Quantity(self.NET_RJ, "K_RJ√s"),
        }

    def __repr__(self):
        s = self.summary()
        return f"Band({', '.join(f'{k}={v}' for k, v in s.items())})"

    def plot(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 1)
        ax.plot(self.nu / 1e9, self.tau, label=self.name)
        ax.set_xlabel(r"$\nu$ [GHz]")
        ax.set_ylabel(r"$\tau(\nu)$")
        ax.legend()
        return ax


class BandList:
    """(reference: maria/band/band_list.py:11)"""

    def __init__(self, bands):
        parsed = []
        for band in bands if isinstance(bands, (list, tuple)) else [bands]:
            parsed.append(parse_band(band))
        self.bands = parsed

    @property
    def names(self):
        return [band.name for band in self.bands]

    def __getitem__(self, key):
        if isinstance(key, str):
            for band in self.bands:
                if band.name == key:
                    return band
            raise KeyError(key)
        return self.bands[key]

    def __iter__(self):
        return iter(self.bands)

    def __len__(self):
        return len(self.bands)

    def __repr__(self):
        return f"BandList({self.names})"


def validate_band_config(band: dict):
    """A band needs either an explicit passband or a (center, width)
    pair (reference maria/band/band.py:48-51)."""
    if "passband" not in band:
        if any(key not in band for key in ("center", "width")):
            raise ValueError("The band's center and width must be specified")


def _build_band_data():
    from ..utils import require

    pd = require("pandas")

    return pd.DataFrame(BAND_CONFIGS).T.sort_index()


# reference parity (band/band.py:35): browsable table of all bands;
# a DataFrame view, built on first use since pandas is optional
def __getattr__(name):
    if name == "band_data":
        return _build_band_data()
    raise AttributeError(name)
