"""Atmospheric layer generation (reference: maria/atmosphere/extrusion.py:27-110).

Host-side: builds the layer table (heights, thicknesses, resolutions,
winds, water content, per-layer pwv_rms) that parameterizes the
turbulence processes.
"""

from __future__ import annotations

import logging

import numpy as np

from ..utils.table import Table

logger = logging.getLogger("maria_tpu")

MIN_RES = {"2d": 2.0, "3d": 15.0}
MIN_RES_PER_BEAM = {"2d": 0.1, "3d": 0.5}
MIN_RES_PER_FOV = {"2d": 0.02, "3d": 0.1}

# fixed slab boundaries for the 2d (integrated-layer) model
H_BOUNDARIES_2D = np.array([0.0, 500.0, 1000.0, 1500.0, 2000.0, 3000.0, 5000.0, 8000.0, 12000.0])


def boundary_layer_profile(h, h_0: float = 1e3, alpha: float = 1 / 7):
    """Turbulence-strength profile: exponential decay x surface-layer growth
    (reference extrusion.py:100-105)."""
    return np.exp(-h / h_0) * h**alpha


def generate_layers(
    instrument,
    boresight,
    weather,
    site,
    mode: str = "2d",
    max_height: float = 5e3,
    min_res: float = None,
    min_res_per_beam: float = None,
    min_res_per_fov: float = None,
    pwv_rms_frac: float = 3e-2,
    n_layers: int = None,
    min_height: float = None,
) -> Table:
    """Layer table. The model is implicitly parameterized at the minimum
    scan elevation."""
    min_res = min_res or MIN_RES[mode]
    min_res_per_beam = min_res_per_beam or MIN_RES_PER_BEAM[mode]
    min_res_per_fov = min_res_per_fov or MIN_RES_PER_FOV[mode]

    min_el = float(np.min(boresight.el))
    sin_el = np.sin(min_el)

    fov = float(instrument.dets.field_of_view.rad)

    def res_func(h):
        h = np.asarray(h, dtype=float)
        z = h / sin_el
        fwhm = instrument.dets.one_detector_from_each_band().physical_fwhm(z[..., None] + 1e-16)
        r2 = min_res_per_beam * np.min(fwhm.m, axis=-1)
        r3 = min_res_per_fov * z * fov
        return np.minimum(1e3, np.maximum.reduce([min_res * np.ones_like(h), r2, r3]))

    if mode == "2d":
        h_boundaries = H_BOUNDARIES_2D.copy()
        if min_height:
            h_boundaries = np.unique(np.maximum(h_boundaries, min_height))
        process_index = np.arange(len(h_boundaries) - 1)
    elif mode == "3d":
        if n_layers is not None:
            # log-spaced slabs: for the fourier 3-D model the vertical
            # correlation lives in the cross-spectra, so layers only
            # discretize the pwv-variance integral (thin near the ground
            # where the boundary-layer profile concentrates turbulence)
            base = min_height or 0.0
            # first slab starts one resolution above the base so the
            # boundaries are strictly increasing (no zero-thickness layer)
            h0 = base + float(res_func(base))
            h_boundaries = np.concatenate([[base], np.geomspace(h0, max_height, n_layers)])
        else:
            # resolution-matched stack (the AR model's isotropic grid)
            h_list = [0.0]
            while True:
                new_h = h_list[-1] + float(res_func(h_list[-1]))
                if new_h > max_height:
                    break
                h_list.append(new_h)
            h_boundaries = np.array(h_list)
        process_index = np.zeros(len(h_boundaries) - 1, dtype=int)
    else:
        raise ValueError(f"Invalid atmosphere model '{mode}' (supported: '2d', '3d').")

    h_centers = (h_boundaries[1:] + h_boundaries[:-1]) / 2

    weather_values = weather(altitude=float(site.altitude.m) + h_centers)
    layers = Table(weather_values)
    layers.insert(0, "process_index", process_index)
    layers.insert(1, "h", h_centers)
    layers.insert(2, "dh", np.diff(h_boundaries))
    layers.insert(3, "res", res_func(h_centers))
    layers.insert(4, "z", h_centers / sin_el)

    # per-layer integrated water (for wind weighting)
    mid_bounds = np.array([0.0, *(h_centers[:-1] + h_centers[1:]) / 2, 1e5])
    total_water = np.empty(len(layers))
    for i, (h1, h2) in enumerate(zip(mid_bounds[:-1], mid_bounds[1:])):
        hh = float(site.altitude.m) + np.linspace(h1, h2, 256)
        w = np.interp(hh, weather.altitude, weather.absolute_humidity)
        total_water[i] = np.trapezoid(w, x=hh)
    layers["total_water"] = total_water

    # distribute the total pwv variance across layers by the boundary-layer profile
    rel_var = boundary_layer_profile(layers.h) ** 2
    pwv_var = (weather.pwv * pwv_rms_frac) ** 2 * rel_var / rel_var.sum()
    layers["pwv_rms"] = np.sqrt(pwv_var)

    logger.debug(f"Generated {len(layers)} layers ({mode} mode), res {layers.res.min():.1f}-{layers.res.max():.1f} m.")
    return layers


# reference-name alias (maria/atmosphere/extrusion.py:27)
construct_extrusion_layers = generate_layers
