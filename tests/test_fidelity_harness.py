"""Fidelity harness (tools/validate_against_reference_data.py).

Offline it must skip cleanly; its parsers for the REAL maria-data
layouts (am v3 spectra, era5 weather, lensed.csv) are exercised here
with fabricated files in those exact layouts, so the online path is
known-good before a network ever exists."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "validate_against_reference_data.py")


def _load_tool():
    spec = importlib.util.spec_from_file_location("fidelity_tool", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tool_runs_offline_and_skips():
    proc = subprocess.run(
        [sys.executable, TOOL, "chajnantor"], capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = next(ln for ln in lines if ln.get("summary"))
    assert summary["errors"] == 0


def _fake_am_h5(path):
    """Tiny file in the real am v3 layout (reference
    maria/spectrum/atmosphere.py:38-57: dims (alt, temp, pwv, el, nu))."""
    alt = np.array([0.0, 3000.0, 6000.0])
    T = np.array([265.0, 275.0, 285.0])
    pwv = np.array([0.5, 1.0, 2.0, 4.0])
    el = np.array([15.0, 45.0, 90.0])
    nu = np.linspace(50e9, 350e9, 64)
    shape = (len(alt), len(T), len(pwv), len(el), len(nu))
    em = 10.0 + np.zeros(shape) + pwv[None, None, :, None, None] * (nu / 1e11)[None, None, None, None, :]
    op = 0.05 + 0.02 * pwv[None, None, :, None, None] + np.zeros(shape)
    with h5py.File(path, "w") as f:
        f["side_altitude_m"] = alt
        f["side_base_temperature_K"] = T
        f["side_zenith_pwv_mm"] = pwv
        f["side_elevation_deg"] = el
        f["side_nu_Hz"] = nu
        f["rayleigh_jeans_temperature_K"] = em
        f["opacity_nepers"] = op
        f["excess_path_m"] = 0.0063 * pwv[None, None, :, None, None] + np.zeros(shape)


def _fake_era5_h5(path):
    """Tiny file in the real era5 layout (reference
    maria/weather/__init__.py:105-131)."""
    q = np.linspace(0.01, 0.99, 5)
    yd_side = np.linspace(0, 365.25, 13)
    dh_side = np.linspace(0, 24, 9)
    p_lev = np.array([1000.0, 700.0, 500.0])
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f["quantile_levels"] = q
        f["pressure_levels"] = p_lev
        f["year_day_side"] = yd_side
        f["day_hour_side"] = dh_side
        f["year_day_edge_index"] = np.arange(len(yd_side))
        f["day_hour_edge_index"] = np.arange(len(dh_side))
        for attr, mean, scale in (
            ("temperature", 270.0, 10.0),
            ("wind_east", 2.0, 5.0),
            ("wind_north", 1.0, 5.0),
            ("humidity", 40.0, 15.0),
        ):
            g = f.create_group(f"data/{attr}")
            nq = np.cumsum(rng.uniform(0, 0.2, (len(yd_side), len(dh_side), len(q), len(p_lev))), axis=2)
            g["normalized_quantiles"] = nq - nq.mean()
            g["scale"] = scale
            g["mean"] = mean


def test_spectrum_parser_against_fake_am(tmp_path, monkeypatch):
    tool = _load_tool()
    fake = tmp_path / "am.h5"
    _fake_am_h5(fake)
    monkeypatch.setattr(tool, "_download", lambda rel, tmp: str(fake))
    out = tool.compare_spectrum("chajnantor", str(tmp_path))
    assert out["status"] == "ok"
    assert len(out["bands"]) >= 8
    for v in out["bands"].values():
        assert np.isfinite(v["emission_rel_err"])
        assert v["emission_K_real"] > 0


def test_weather_parser_against_fake_era5(tmp_path, monkeypatch):
    tool = _load_tool()
    fake = tmp_path / "era5.h5"
    _fake_era5_h5(fake)
    monkeypatch.setattr(tool, "_download", lambda rel, tmp: str(fake))
    out = tool.compare_weather("chajnantor", str(tmp_path))
    assert out["status"] == "ok"
    assert "temperature" in out["fields"]
    for v in out["fields"].values():
        assert np.isfinite(v["rel_err"])


def test_cmb_parser_against_fake_csv(tmp_path, monkeypatch):
    import pandas as pd

    tool = _load_tool()
    ell = np.arange(2, 2501)
    fake = tmp_path / "lensed.csv"
    pd.DataFrame(
        {"TT": 1e-10 / ell**2, "EE": 1e-12 / ell**2, "BB": 1e-14 / ell**2, "TE": 1e-11 / ell**2},
        index=ell,
    ).to_csv(fake)
    monkeypatch.setattr(tool, "_download", lambda rel, tmp: str(fake))
    out = tool.compare_cmb_spectra(str(tmp_path))
    assert out["status"] == "ok"
    assert set(out["fields"]) == {"TT", "EE", "BB", "TE"}


@pytest.mark.internet
def test_fidelity_against_real_data():
    """With real egress: the synthetic spectra must sit within 30% of the
    am grids in every band, and the CMB TT spectrum within 25% rms."""
    if os.environ.get("MARIA_TPU_INTERNET") != "1":
        pytest.skip("network tests run only with MARIA_TPU_INTERNET=1")
    proc = subprocess.run(
        [sys.executable, TOOL, "--download", "chajnantor"],
        capture_output=True, text=True, timeout=1200,
    )
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    spec = next(ln for ln in lines if ln.get("comparison") == "spectrum")
    if spec["status"] == "skipped-offline":
        pytest.skip("no egress to maria-data")
    assert spec["emission_rel_err_median"] < 0.3
