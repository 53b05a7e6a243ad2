"""Fidelity harness: synthetic generators vs the REAL maria-data products.

The framework is fully functional offline because spectra, weather and
CMB inputs are synthesized locally (spectrum/synth.py, weather/,
cmb/spectra.py). This tool quantifies how far those synthetics sit from
the real products the reference users calibrate against (VERDICT r2
"Missing #1"):

- atmosphere spectra: `am`-computed 4-D grids
  (reference maria/spectrum/atmosphere.py:26-57) — band-binned relative
  error of emission and opacity vs frequency at matched
  (T_base, pwv, elevation, altitude);
- weather: ERA5-derived quantile grids
  (reference maria/weather/__init__.py:91-135) — surface-level
  temperature / wind / pwv-proxy medians at a matched season and hour;
- CMB spectra: the lensed TT/EE/BB/TE table (maria/cmb/generation.py:20)
  vs our anchor table.

Downloads go straight to the network (NEVER through the offline
generator fallback — that would compare the synthetic against itself),
and only with `--download`. Without it every comparison reports
{"status": "skipped-offline"} and the tool exits 0.

Usage: python tools/validate_against_reference_data.py [--download] [region ...]
Output: one JSON line per comparison + a summary line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

SOURCE_BASE = "https://github.com/thomaswmorris/maria-data/raw/master"
BANDS_GHZ = {"f090": (75, 105), "f150": (125, 170), "f220": (195, 245), "f280": (255, 305)}


_ONLINE = {"download": False}


def _download(rel_path: str, dest_dir: str):
    """Network-only fetch (no generator fallback). None unless the tool
    was started with --download, or when the download fails."""
    if not _ONLINE["download"]:
        return None
    from maria_tpu.io.caching import _download as dl

    dest = os.path.join(dest_dir, rel_path.replace("/", "_"))
    return dest if dl(f"{SOURCE_BASE}/{rel_path}", dest, timeout=30.0) else None


def compare_spectrum(region: str, tmp: str) -> dict:
    import h5py

    path = _download(f"atmosphere/spectra/am/v3/{region}.h5", tmp)
    if path is None:
        return {"comparison": "spectrum", "region": region, "status": "skipped-offline"}

    from maria_tpu.site.regions import region_entry
    from maria_tpu.spectrum import AtmosphericSpectrum

    altitude = float(region_entry(region).altitude)
    with h5py.File(path, "r") as f:
        alt = f["side_altitude_m"][:].astype(float)
        T_side = f["side_base_temperature_K"][:].astype(float)
        el_side = np.radians(f["side_elevation_deg"][:].astype(float))
        pwv_side = f["side_zenith_pwv_mm"][:].astype(float)
        nu = f["side_nu_Hz"][:].astype(float)
        # dims: (alt, temp, pwv, el, nu); interpolate out the altitude
        # axis exactly like the reference loader
        import scipy.interpolate

        em = scipy.interpolate.interp1d(alt, f["rayleigh_jeans_temperature_K"][:], axis=0)(altitude)
        op = scipy.interpolate.interp1d(alt, f["opacity_nepers"][:], axis=0)(altitude)

    ours = AtmosphericSpectrum(region)
    T0 = float(np.median(T_side))
    el0 = np.radians(45.0)
    iT = int(np.argmin(np.abs(T_side - T0)))
    iel = int(np.argmin(np.abs(el_side - el0)))

    out = {"comparison": "spectrum", "region": region, "status": "ok", "bands": {}}
    for pwv0 in (0.5, 1.0, 2.0, 4.0):
        ip = int(np.argmin(np.abs(pwv_side - pwv0)))
        pwv_real = float(pwv_side[ip])
        for name, (lo, hi) in BANDS_GHZ.items():
            sel = (nu >= lo * 1e9) & (nu <= hi * 1e9)
            em_real = float(em[iT, ip, iel, sel].mean())
            op_real = float(op[iT, ip, iel, sel].mean())
            nu_band = nu[sel]
            em_ours = float(np.mean(ours.emission(nu_band, pwv=pwv_real,
                                                  base_temperature=float(T_side[iT]),
                                                  elevation=float(el_side[iel]))))
            op_ours = float(np.mean(ours.opacity(nu_band, pwv=pwv_real,
                                                 base_temperature=float(T_side[iT]),
                                                 elevation=float(el_side[iel]))))
            key = f"{name}_pwv{pwv_real:g}"
            out["bands"][key] = {
                "emission_K_real": round(em_real, 3),
                "emission_K_ours": round(em_ours, 3),
                "emission_rel_err": round(abs(em_ours - em_real) / max(em_real, 1e-9), 4),
                "opacity_real": round(op_real, 4),
                "opacity_ours": round(op_ours, 4),
                "opacity_rel_err": round(abs(op_ours - op_real) / max(op_real, 1e-9), 4),
            }
    errs = [v["emission_rel_err"] for v in out["bands"].values()]
    out["emission_rel_err_median"] = round(float(np.median(errs)), 4)
    out["emission_rel_err_max"] = round(float(np.max(errs)), 4)
    return out


def compare_weather(region: str, tmp: str) -> dict:
    import h5py

    path = _download(f"atmosphere/weather/era5/{region}.h5", tmp)
    if path is None:
        return {"comparison": "weather", "region": region, "status": "skipped-offline"}

    import scipy.interpolate

    from maria_tpu.utils import get_utc_day_hour, get_utc_year_day
    from maria_tpu.weather import Weather

    t0 = 1.75e9  # fixed epoch for reproducibility
    yd, dh = get_utc_year_day(t0), get_utc_day_hour(t0)

    real = {}
    with h5py.File(path, "r") as f:
        q_levels = f["quantile_levels"][:]
        yd_side = f["year_day_side"][:]
        dh_side = f["day_hour_side"][:]
        yd_edge = f["year_day_edge_index"][:]
        dh_edge = f["day_hour_edge_index"][:]
        YD, DH = np.meshgrid(yd_edge, dh_edge, indexing="ij")
        for attr in f["data"]:
            grid = (
                f["data"][attr]["normalized_quantiles"][:] * f["data"][attr]["scale"][()]
                + f["data"][attr]["mean"][()]
            )
            y = scipy.interpolate.RegularGridInterpolator(
                (yd_side, dh_side, q_levels), grid[YD, DH]
            )((yd, dh, 0.5))
            real[attr] = np.atleast_1d(np.asarray(y, dtype=float))

    ours = Weather(region=region, time=t0)
    out = {"comparison": "weather", "region": region, "status": "ok", "fields": {}}
    for attr in ("temperature", "wind_east", "wind_north", "humidity"):
        if attr not in real or attr not in ours.fields:
            continue
        # surface-level value: last pressure level is closest to ground
        r = float(np.asarray(real[attr]).ravel()[-1])
        o = float(np.asarray(ours.data[attr]).ravel()[-1])
        scale = max(abs(r), 1e-9) if attr == "temperature" else max(abs(r), 1.0)
        out["fields"][attr] = {
            "real": round(r, 3), "ours": round(o, 3),
            "rel_err": round(abs(o - r) / scale, 4),
        }
    return out


def compare_cmb_spectra(tmp: str) -> dict:
    path = _download("cmb/spectra/lensed.csv", tmp)
    if path is None:
        return {"comparison": "cmb_spectra", "status": "skipped-offline"}

    import pandas as pd

    from maria_tpu.cmb.spectra import get_cmb_spectrum

    real = pd.read_csv(path, index_col=0)
    ours = get_cmb_spectrum(lmax=4000)  # dict: TT/EE/BB/TE C_l in K^2
    out = {"comparison": "cmb_spectra", "status": "ok", "fields": {}}
    ell = np.asarray(real.index, dtype=float)
    for col in real.columns:
        if col not in ours:
            continue
        sel = (ell >= 30) & (ell <= 2000)
        r = np.asarray(real[col], dtype=float)[sel]
        o = np.interp(ell[sel], ours["ell"], ours[col])
        denom = float(np.sqrt(np.mean(r**2))) or 1.0
        out["fields"][col] = {"rms_rel_err": round(float(np.sqrt(np.mean((o - r) ** 2)) / denom), 4)}
    return out


def main(regions) -> None:
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for region in regions:
            for fn in (compare_spectrum, compare_weather):
                try:
                    res = fn(region, tmp)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    res = {"comparison": fn.__name__, "region": region,
                           "status": f"error: {type(e).__name__}: {e}"[:300]}
                results.append(res)
                print(json.dumps(res), flush=True)
        try:
            res = compare_cmb_spectra(tmp)
        except Exception as e:  # noqa: BLE001
            res = {"comparison": "cmb_spectra", "status": f"error: {e}"[:300]}
        results.append(res)
        print(json.dumps(res), flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped-offline" for r in results)
    print(json.dumps({"summary": True, "ok": n_ok, "skipped_offline": n_skip,
                      "errors": len(results) - n_ok - n_skip}))


if __name__ == "__main__":
    args = sys.argv[1:]
    _ONLINE["download"] = "--download" in args
    main([a for a in args if a != "--download"] or ["chajnantor", "green_bank"])
