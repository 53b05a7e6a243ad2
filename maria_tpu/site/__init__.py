"""Observing sites (reference: maria/site/site.py:21-92, site/sites/*.yml)."""

from __future__ import annotations

from ..coords.earth import EarthLocation
from ..errors import InvalidRegionError, InvalidSiteError
from ..units import Quantity
from .regions import REGIONS, all_regions, region_entry

__all__ = [
    "Site",
    "REGIONS",
    "all_regions",
    "all_sites",
    "get_site",
    "get_site_config",
    "get_location",
    "get_height_map",
    "InvalidRegionError",
    "InvalidSiteError",
]

# named sites: telescope facilities mapped to regions, with any overrides
SITE_CONFIGS = {
    "ACT": {"aliases": ["act"], "region": "chajnantor", "altitude": 5190, "description": "Atacama Cosmology Telescope"},
    "ALMA": {"aliases": ["alma"], "region": "chajnantor", "altitude": 5040, "description": "Atacama Large Millimeter Array"},
    "AMT": {"aliases": ["amt"], "region": "chajnantor", "altitude": 5040, "description": "Africa Millimetre Telescope (placeholder region)"},
    "APEX": {"aliases": ["apex"], "region": "chajnantor", "altitude": 5064, "description": "Atacama Pathfinder Experiment"},
    "GBT": {"aliases": ["gbt", "green_bank"], "region": "green_bank", "altitude": 807, "description": "Green Bank Telescope"},
    "IRAM30m": {"aliases": ["iram", "pico_veleta"], "region": "pico_veleta", "altitude": 2850, "description": "IRAM 30m Telescope"},
    "JCMT": {"aliases": ["jcmt", "mauna_kea"], "region": "mauna_kea", "altitude": 4092, "description": "James Clerk Maxwell Telescope"},
    "LLAMA": {"aliases": ["llama"], "region": "chajnantor", "altitude": 4825, "description": "Large Latin American Millimeter Array"},
    "LMT": {"aliases": ["lmt", "sierra_negra"], "region": "sierra_negra", "altitude": 4640, "description": "Large Millimeter Telescope"},
    "NOEMA": {"aliases": ["noema", "pic_de_bure"], "region": "pic_de_bure", "altitude": 2552, "description": "Northern Extended Millimeter Array"},
    "SMA": {"aliases": ["sma"], "region": "mauna_kea", "altitude": 4080, "description": "Submillimeter Array"},
    "SPT": {"aliases": ["spt", "south_pole"], "region": "south_pole", "altitude": 2835, "description": "South Pole Telescope"},
    "SRT": {"aliases": ["srt", "san_basilio"], "region": "san_basilio", "altitude": 600, "description": "Sardinia Radio Telescope"},
    "effelsberg": {"aliases": [], "region": "effelsberg", "altitude": 319, "description": "Effelsberg 100m Radio Telescope"},
    "hoagie_haven": {"aliases": ["princeton"], "region": "princeton", "altitude": 58, "description": "Hoagie Haven (test site)"},
    "meerkat": {"aliases": [], "region": "meerkat", "altitude": 1075, "description": "MeerKAT"},
    "summit_camp": {"aliases": ["summit_station"], "region": "summit_camp", "altitude": 3202, "description": "Summit Station, Greenland"},
    "teide": {"aliases": [], "region": "teide", "altitude": 2390, "description": "Teide Observatory"},
    "alicpt": {"aliases": [], "region": "ngari", "altitude": 5250, "description": "Ali CMB Polarization Telescope, Tibet"},
    "amundsen_scott": {"aliases": [], "region": "south_pole", "altitude": 2835, "description": "Amundsen-Scott South Pole Station"},
    "cerro_chajnantor": {"aliases": [], "region": "chajnantor", "altitude": 5612, "description": "Cerro Chajnantor summit (TAO/FYST)"},
    "cerro_toco": {"aliases": [], "region": "chajnantor", "altitude": 5300, "description": "Cerro Toco (ACT/CLASS/SO site)"},
    "llano_de_chajnantor": {"aliases": [], "region": "chajnantor", "altitude": 5064, "description": "Llano de Chajnantor plateau"},
    "pituffik": {"aliases": [], "region": "thule", "altitude": 76, "description": "Pituffik Space Base, Greenland"},
    "qitai": {"aliases": [], "region": "qitai", "altitude": 1800, "description": "Qitai Radio Telescope, Xinjiang"},
    "very_large_array": {"aliases": ["vla"], "region": "san_agustin", "altitude": 2124, "description": "Very Large Array"},
}

all_sites = sorted(SITE_CONFIGS)


def _build_site_data():
    """DataFrame of all named sites (reference: maria/site/__init__.py:30);
    needs the optional pandas."""
    from ..utils import require

    pd = require("pandas")
    rows = {}
    for name, cfg in SITE_CONFIGS.items():
        entry = region_entry(cfg["region"])
        rows[name] = {
            "description": cfg.get("description", ""),
            "region": cfg["region"],
            "latitude": float(entry.latitude),
            "longitude": float(entry.longitude),
            "altitude": float(cfg.get("altitude", entry.altitude)),
        }
    return pd.DataFrame(rows).T.sort_values("region")


def __getattr__(name):
    if name == "site_data":
        return _build_site_data()
    raise AttributeError(name)


class Site:
    """Earth location + region (reference: maria/site/site.py:39)."""

    def __init__(
        self,
        region: str,
        altitude: float = None,
        latitude: float = None,
        longitude: float = None,
        description: str = "",
        documentation: str = "",
        name: str = None,
        **extra,
    ):
        if region not in all_regions:
            raise InvalidRegionError(region, valid=all_regions)
        self.name = name or region
        self.region = region
        self.description = description
        self.documentation = documentation
        entry = region_entry(region)
        self.latitude = Quantity(latitude if latitude is not None else entry.latitude, "deg")
        self.longitude = Quantity(longitude if longitude is not None else entry.longitude, "deg")
        self.altitude = Quantity(altitude if altitude is not None else entry.altitude, "m")

    @property
    def earth_location(self) -> EarthLocation:
        return EarthLocation(
            lat_deg=float(self.latitude.deg),
            lon_deg=float(self.longitude.deg),
            height_m=float(self.altitude.m),
        )

    def plot(self, ax=None):
        """World map of all known regions with this site highlighted
        (reference: maria/site/site.py:92+, which draws a fetched world
        height map; offline we draw the region catalog itself)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(1, 1, figsize=(9, 4.5))
        try:
            hm = get_height_map()
            ax.imshow(hm, extent=(-180, 180, -90, 90), cmap="gist_earth", alpha=0.6, aspect="auto")
        except Exception:  # noqa: BLE001 — the map background is cosmetic
            pass
        sc = ax.scatter(
            REGIONS.longitude, REGIONS.latitude, c=REGIONS.altitude,
            cmap="terrain", s=18, vmin=0,
        )
        ax.scatter(
            [float(self.longitude.deg)], [float(self.latitude.deg)],
            marker="*", s=220, facecolor="none", edgecolor="red", linewidth=1.5,
        )
        ax.annotate(
            self.name, (float(self.longitude.deg), float(self.latitude.deg)),
            textcoords="offset points", xytext=(8, 8), color="red",
        )
        ax.set_xlim(-180, 180)
        ax.set_ylim(-90, 90)
        ax.set_xlabel("longitude [deg]")
        ax.set_ylabel("latitude [deg]")
        ax.grid(alpha=0.3)
        plt.colorbar(sc, ax=ax, label="altitude [m]")
        return ax

    def __repr__(self):
        return (
            f"Site({self.name}):\n"
            f"  region: {self.region}\n"
            f"  location: {self.earth_location}\n"
            f"  altitude: {self.altitude}"
        )


def get_site(site_name: str, **kwargs) -> Site:
    for name, config in SITE_CONFIGS.items():
        if site_name == name or site_name in config.get("aliases", []):
            cfg = {k: v for k, v in config.items() if k != "aliases"}
            cfg.update(kwargs)
            return Site(name=name, **cfg)
    if site_name in all_regions:
        return Site(region=site_name, **kwargs)
    raise InvalidSiteError(site_name, valid=all_sites + all_regions)


def get_site_config(site_name: str = "hoagie_haven", **kwargs) -> dict:
    """Raw config dict for a named site, with keyword overrides
    (reference maria/site/__init__.py:51-57)."""
    for name, config in SITE_CONFIGS.items():
        if site_name == name or site_name in config.get("aliases", []):
            cfg = {k: v for k, v in config.items() if k != "aliases"}
            cfg.update(kwargs)
            return cfg
    raise InvalidSiteError(site_name, valid=all_sites)


def get_location(site_name: str) -> EarthLocation:
    """Earth location of a named site (reference
    maria/site/__init__.py:42-48, which returns an astropy
    EarthLocation; ours is the dependency-free equivalent)."""
    return get_site(site_name).earth_location


def _generate_height_map(source_path: str, destination: str):
    """Synthesize an offline world height map in the maria-data format:
    uint16 'data' with height/32 per cell (clipped to 254) and 255
    marking ocean — the convention the reference decodes at
    maria/site/site.py:33-36.

    Continents are modeled as smooth Gaussian massifs centered on the
    cataloged observing regions (scaled to their true altitudes) over a
    low-lying land background; good enough for the site world-map plot,
    which is the only consumer."""
    import numpy as np

    lat = np.linspace(90, -90, 361)
    lon = np.linspace(-180, 180, 721)
    LON, LAT = np.meshgrid(lon, lat)
    height = np.full(LON.shape, 100.0)
    for _, entry in REGIONS.iterrows():
        d2 = (LAT - float(entry.latitude)) ** 2 + (LON - float(entry.longitude)) ** 2
        height += float(entry.altitude) * np.exp(-d2 / (2 * 6.0**2))
    # crude ocean mask: far from every region -> ocean
    d2_min = np.full(LON.shape, np.inf)
    for _, entry in REGIONS.iterrows():
        d2 = (LAT - float(entry.latitude)) ** 2 + (LON - float(entry.longitude)) ** 2
        d2_min = np.minimum(d2_min, d2)
    data = np.where(d2_min < 40.0**2, np.clip(height / 32, 0, 254).astype(np.uint16), np.uint16(255))
    import os
    import tempfile

    with tempfile.NamedTemporaryFile(dir=os.path.dirname(destination) or ".", delete=False) as f:
        np.save(f, data)
    os.replace(f.name, destination)


def get_height_map():
    """Global terrain height in meters, NaN over ocean (reference
    maria/site/site.py:33-36 fetches world_heightmap.h5 from
    maria-data; we synthesize one from the region catalog)."""
    import numpy as np

    from ..io.caching import fetch, register_generator

    register_generator("world_heightmap", _generate_height_map)
    height_map = np.load(fetch("world_heightmap.npy")).astype(np.float64)
    return np.where(height_map < 255, 32 * height_map, np.nan)

# columns shown in site/region tables (reference: site/__init__.py:22, site/site.py:20)
SITE_DISPLAY_COLUMNS = ["description", "instruments", "region", "latitude", "longitude", "altitude"]
REGION_DISPLAY_COLUMNS = ["location", "country", "latitude", "longitude", "timezone"]
