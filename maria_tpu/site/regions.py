"""Observing regions: geographic facts (reference: maria/site/regions.csv).

lat/lon in degrees, altitudes in meters. `pwv_scale_mm` is the synthetic
climatological median zenith PWV used by the offline weather generator
(dry high sites small, humid low sites large).
"""

from __future__ import annotations

from types import SimpleNamespace

from ..utils.table import Table

_REGION_ROWS = [
    # name, location, country, lat, lon, alt, min_alt, max_alt, utc_offset_hr, pwv_scale_mm
    ("boolardy", "Boolardy, Western Australia", "Australia", -26.697, 116.631, 395, 250, 500, 8.0, 15.0),
    ("boston", "Cambridge, Massachusetts", "USA", 42.374, -71.111, 8, 0, 100, -5.0, 18.0),
    ("chajnantor", "Llano de Chajnantor, Antofagasta", "Chile", -23.006, -67.759, 5040, 4000, 5750, -4.0, 1.1),
    ("chiang_mai", "Chiang Mai, Thailand", "Thailand", 18.864, 99.217, 395, 0, 2000, 7.0, 30.0),
    ("effelsberg", "Effelsberg, North Rhine-Westphalia", "Germany", 50.524, 6.883, 319, 0, 500, 1.0, 14.0),
    ("green_bank", "Green Bank, West Virginia", "USA", 38.433, -79.840, 807, 500, 1500, -5.0, 12.0),
    ("mauna_kea", "Mauna Kea, Hawaii", "USA", 19.823, -155.475, 4205, 3500, 4500, -10.0, 1.8),
    ("meerkat", "Meerkat National Park, Northern Cape", "South Africa", -30.713, 21.443, 1075, 750, 1250, 2.0, 10.0),
    ("metsahovi", "Metsähovi, Kirkkonummi", "Finland", 60.218, 24.394, 90, 0, 250, 2.0, 12.0),
    ("minamimaki", "Minamimaki, Nagano", "Japan", 35.942, 138.476, 1350, 1000, 2500, 9.0, 10.0),
    ("mount_graham", "Mount Graham, Arizona", "USA", 32.702, -109.890, 3178, 2500, 3500, -7.0, 4.0),
    ("narrabri", "Narrabri, New South Wales", "Australia", -30.314, 149.562, 237, 160, 500, 10.0, 16.0),
    ("ngari", "Ngari Prefecture, Tibet", "China", 32.326, 80.026, 5176, 4500, 5500, 8.0, 1.5),
    ("owens_valley", "Owens Valley, California", "USA", 37.232, -118.295, 1222, 1000, 3500, -8.0, 7.0),
    ("pic_de_bure", "Plateau de Bure, Haute-Alpes", "France", 44.634, 5.908, 2552, 2000, 2750, 1.0, 5.0),
    ("pico_veleta", "Pico Veleta, Granada", "Spain", 37.066, -3.393, 2850, 2500, 3500, 1.0, 4.5),
    ("princeton", "Princeton, New Jersey", "USA", 40.345, -74.651, 58, 0, 250, -5.0, 18.0),
    ("qitai", "Qitai, Xinjiang", "China", 43.601, 89.699, 1780, 1500, 2000, 6.0, 8.0),
    ("san_agustin", "Plains of San Agustín, New Mexico", "USA", 34.079, -107.618, 2124, 2000, 2500, -7.0, 6.0),
    ("san_basilio", "San Basilio, Sardinia", "Italy", 39.493, 9.245, 600, 500, 1000, 1.0, 14.0),
    ("sierra_negra", "Sierra Negra, Puebla", "Mexico", 18.986, -97.314, 4640, 4000, 5500, -6.0, 2.5),
    ("south_pole", "South Pole", "Antarctica", -90.0, 0.0, 2835, 2750, 3000, 0.0, 0.6),
    ("summit_camp", "Summit Station, Greenland", "Greenland", 72.583, -38.455, 3202, 3100, 3200, -3.0, 1.5),
    ("teide", "Mount Teide, Tenerife", "Spain", 28.301, -16.511, 2390, 2000, 3750, 0.0, 5.0),
    ("thule", "Thule Air Base", "Greenland", 76.535, -68.686, 77, 0, 500, -4.0, 6.0),
]

_REGION_COLUMNS = [
    "name", "location", "country", "latitude", "longitude",
    "altitude", "min_altitude", "max_altitude", "utc_offset_hr", "pwv_scale_mm",
]

REGIONS = Table({col: [row[i] for row in _REGION_ROWS] for i, col in enumerate(_REGION_COLUMNS)})

all_regions = [str(name) for name in REGIONS.name]



def region_entry(region: str) -> SimpleNamespace:
    """One region's row, with its columns as attributes."""
    i = all_regions.index(region)
    return SimpleNamespace(**{col: REGIONS[col][i] for col in REGIONS.columns})
