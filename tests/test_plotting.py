"""Plotting surface smoke tests (reference: maria/plotting/)."""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import maria_tpu  # noqa: E402


@pytest.fixture(scope="module")
def tod():
    plan = maria_tpu.get_plan("five_second_stare", start_time=1.75e9, scan_center=(60.0, 45.0))
    sim = maria_tpu.Simulation(
        instrument="test/1deg", plans=plan, site="chajnantor",
        atmosphere="2d", noise=True, seed=0, progress_bars=True,
    )
    return sim.run(units="pW")[0]


def test_plot_tod_with_noise_overlay(tod):
    from maria_tpu.plotting import plot_tod
    fig = plot_tod(tod)
    assert fig is not None
    plt.close("all")


def test_twinkle_plot(tod):
    from maria_tpu.plotting import twinkle_plot
    anim = twinkle_plot(tod, n_frames=4)
    assert anim is not None
    plt.close("all")


def test_healpix_mollweide():
    from maria_tpu.cmb import generate_cmb

    cmb = generate_cmb(nside=32, seed=1)
    ax = cmb.plot(n_grid=60)
    assert ax is not None
    plt.close("all")


def test_site_world_map():
    site = maria_tpu.get_site("GBT")
    ax = site.plot()
    assert ax is not None
    plt.close("all")


def test_new_instrument_configs_load():
    hd = maria_tpu.get_instrument("cmb-hd-mini")
    assert hd.dets.n == 250
    nm = maria_tpu.get_instrument("NEW-MUSIC")
    assert nm.dets.n == 64 + 64 + 256 + 256 + 1024 + 1024
    assert len(nm.dets.bands) == 6


def test_progress_bar_and_log_duration():
    from maria_tpu.io.logging import log_duration, progress_bar

    assert sum(progress_bar(range(5), disable=True)) == 10
    with log_duration("noop"):
        pass
