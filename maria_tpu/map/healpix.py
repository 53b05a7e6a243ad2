"""All-sky HEALPix maps (reference: maria/map/healpix.py:17-150).

Data shape (stokes, nu, t, npix), RING ordering. Sampling along a line
of sight is an `ang2pix` gather in pure jnp.
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np

from ..coords import ephemeris as eph
from ..healpix.core import ang2pix_ring, npix2nside, nside2npix, pix2ang_ring
from ..units import Quantity
from .base import Map

logger = logging.getLogger("maria_tpu")


class HEALPixMap(Map):
    map_dims = ("pixel",)

    def __init__(
        self,
        data,
        frame: str = "galactic",
        stokes: str = None,
        nu=None,
        t=None,
        z=None,
        v=None,
        units: str = "K_CMB",
        weight=None,
        dtype=jnp.float32,
        degrees: bool = True,
        resolution=None,
    ):
        super().__init__(
            data, stokes=stokes, nu=nu, t=t, z=z, v=v, units=units, weight=weight, dtype=dtype
        )
        self.frame = frame
        self.nside = npix2nside(self.data.shape[-1])
        if resolution is not None:
            # accepted for reference-docs parity (usage/inputs/maps); on
            # a HEALPix grid the resolution is fixed by npix, so we only
            # check consistency (within a factor ~2) rather than store it
            res_rad = float(resolution) * (np.pi / 180 if degrees else 1.0)
            native = np.sqrt(4 * np.pi / nside2npix(self.nside))
            if not (0.4 < res_rad / native < 2.5):
                logger.warning(
                    f"Requested resolution {res_rad:.2e} rad differs from the "
                    f"HEALPix nside={self.nside} native {native:.2e} rad; ignoring."
                )

    def _replace(self, **kwargs):
        params = dict(
            data=self.data, frame=self.frame, stokes=self.stokes,
            nu=self.nu, **self._axis3_kwargs(), units=self.units, weight=self.weight,
        )
        if any(k in kwargs for k in ("t", "z", "v")):
            params.pop(self.axis3_label, None)
        params.update(kwargs)
        return HEALPixMap(**params)

    def _calibration_kwargs(self):
        return {"pixel_area": 4 * np.pi / nside2npix(self.nside)}

    @property
    def npix(self):
        return self.data.shape[-1]

    @property
    def resolution(self) -> float:
        return float(np.sqrt(4 * np.pi / self.npix))

    # -- device sampling ------------------------------------------------------------
    def pixel_index(self, phi, theta_lat):
        """RING pixel of (longitude, latitude) in the map's frame; pure jnp."""
        return ang2pix_ring(self.nside, jnp.pi / 2 - theta_lat, phi)

    def sample_stokes(self, pointing, stokes_weight, nu_index: int = 0, t_index: int = 0):
        """Stokes-weighted sample along each line of sight: shape (n_det, n_t).

        `pointing` is a tod.Pointing; coordinates are converted to the
        map's frame on device (ICRS -> galactic is one 3x3 matmul).
        """
        ra, dec = pointing.det_radec()
        if self.frame == "galactic":
            R = jnp.asarray(eph.ICRS_TO_GAL, dtype=jnp.float32)
            cos_d = jnp.cos(dec)
            v = jnp.stack([jnp.cos(ra) * cos_d, jnp.sin(ra) * cos_d, jnp.sin(dec)], axis=-1)
            v_gal = jnp.einsum("ij,...j->...i", R, v)
            phi = jnp.arctan2(v_gal[..., 1], v_gal[..., 0])
            lat = jnp.arcsin(jnp.clip(v_gal[..., 2], -1, 1))
        elif self.frame == "ra/dec":
            phi, lat = ra, dec
        else:
            raise ValueError(f"Cannot sample a HEALPixMap in frame '{self.frame}'.")

        pix = self.pixel_index(phi, lat)
        out = 0.0
        for s in range(self.n_stokes):
            w = stokes_weight[:, s][:, None]
            field = jnp.asarray(self.data[s, nu_index, t_index])
            out = out + w * jnp.take(field, pix, axis=0)
        return out

    def smooth(self, fwhm) -> "HEALPixMap":
        """Harmonic-space Gaussian smoothing (reference healpix.py:126).

        All (stokes, nu, t) slices transform in ONE batched device scan;
        Q/U pairs are smoothed with the spin-2 transform (scalar-smoothing
        them would mix E/B power near the poles)."""
        from ..healpix.sht import alm2map, alm2map_spin, map2alm, map2alm_spin

        fwhm_rad = float(np.asarray(Quantity(fwhm, "rad")))
        sigma = fwhm_rad / (2 * np.sqrt(2 * np.log(2)))
        lmax = min(3 * self.nside - 1, 2048)
        ells = np.arange(lmax + 1)
        beam = np.exp(-0.5 * ells * (ells + 1) * sigma**2)[:, None]

        data = np.asarray(self.data, dtype=float)
        new_data = data.copy()
        scalar = [i for i, s in enumerate(self.stokes) if s not in "QU"]
        if scalar:
            alm = map2alm(data[scalar].reshape(len(scalar) * self.n_nu * len(self.t), -1), lmax=lmax)
            sm = alm2map(alm * beam, self.nside)
            new_data[scalar] = sm.reshape(len(scalar), self.n_nu, len(self.t), -1)
        if "Q" in self.stokes and "U" in self.stokes:
            iq, iu = self.stokes.index("Q"), self.stokes.index("U")
            Q = data[iq].reshape(-1, data.shape[-1])
            U = data[iu].reshape(-1, data.shape[-1])
            aE, aB = map2alm_spin(Q, U, lmax=lmax)
            Qs, Us = alm2map_spin(aE * beam, aB * beam, self.nside)
            new_data[iq] = Qs.reshape(self.n_nu, len(self.t), -1)
            new_data[iu] = Us.reshape(self.n_nu, len(self.t), -1)
        return self._replace(data=jnp.asarray(new_data, dtype=self.dtype))

    def to_hdf(self, path: str):
        from ..utils import require

        h5py = require("h5py")
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=np.asarray(self.data))
            f.attrs["stokes"] = self.stokes
            f.attrs["units"] = self.units
            f.attrs["frame"] = self.frame
            f.attrs["axis3_label"] = self.axis3_label
            f.create_dataset("nu", data=self.nu)
            f.create_dataset("t", data=self.t)

    def plot(self, slices=None, **kwargs):
        """Mollweide view (reference: maria/plotting/healpix.py). With
        `slices` ("all" or a dict, like ProjectionMap.plot) a panel grid
        is drawn over the slice dims."""
        if slices is not None:
            from ..plotting.map import plot_map_slices

            return plot_map_slices(self, slices=slices, **kwargs)
        from ..plotting.healpix import plot_healpix_map

        return plot_healpix_map(self, **kwargs)

    def __repr__(self):
        base = super().__repr__()[:-1]
        return base + f", nside={self.nside}, frame='{self.frame}')"
