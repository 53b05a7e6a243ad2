"""Instruments: detector arrays + telescope kinematics
(reference: maria/instrument/instrument.py:67-171, instrument/__init__.py:23-69)."""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

from ..array import Array, ArrayList
from ..band import Band, BandList  # noqa: F401  (reference: instrument re-exports)
from ..errors import InvalidInstrumentError
from ..io import read_json
from ..units import Quantity

here = os.path.dirname(__file__)
logger = logging.getLogger("maria_tpu")

INSTRUMENT_CONFIGS = {}
for path in sorted(glob.glob(f"{here}/configs/*.json")):
    _tag = os.path.splitext(os.path.basename(path))[0]
    for _key, _cfg in read_json(path).items():
        # the reference registers instruments under flattened
        # "<file>/<name>" keys (instrument/__init__.py:23-34); accept
        # both the bare name and the flattened form as aliases
        _cfg.setdefault("aliases", []).append(f"{_tag}/{_key}".lower())
        INSTRUMENT_CONFIGS[_key] = _cfg

all_instruments = sorted(INSTRUMENT_CONFIGS)
test_instruments = ["test/1deg"]


class Instrument:
    def __init__(
        self,
        arrays,
        name: str = None,
        description: str = "",
        documentation: str = "",
        az_vel_limit: float = 3.0,  # deg/s
        az_acc_limit: float = 1.0,  # deg/s^2
        el_vel_limit: float = 2.0,
        el_acc_limit: float = 1.0,
        min_elevation: float = 20.0,  # deg
        max_elevation: float = 90.0,
    ):
        # entries may be Array objects, config dicts, or registry names
        # (reference docs usage/inputs/instruments/arrays/generation.rst:
        # Instrument(arrays=[my_array]) with a dict)
        arrays = arrays if isinstance(arrays, (list, tuple, ArrayList)) else [arrays]
        resolved = []
        for i, a in enumerate(arrays):
            if isinstance(a, dict):
                resolved.append(Array.from_config({"name": a.get("name", f"array-{i}"), **a}))
            elif isinstance(a, str):
                from ..array import get_array

                resolved.append(get_array(a))
            else:
                resolved.append(a)
        self.arrays = ArrayList(resolved)
        self.name = name or "+".join(a.name for a in self.arrays)
        self.description = description
        self.documentation = documentation
        self.az_vel_limit = Quantity(az_vel_limit, "deg/s")
        self.az_acc_limit = Quantity(az_acc_limit, "deg/s^2")
        self.el_vel_limit = Quantity(el_vel_limit, "deg/s")
        self.el_acc_limit = Quantity(el_acc_limit, "deg/s^2")
        self.min_elevation = Quantity(min_elevation, "deg")
        self.max_elevation = Quantity(max_elevation, "deg")
        self._dets = None

    @classmethod
    def from_config(cls, config: dict, name: str = None) -> "Instrument":
        c = dict(config)
        c.pop("aliases", None)
        array_configs = {}
        if "array" in c:
            array_configs[name or "array"] = c.pop("array")
        if "arrays" in c:
            arrs = c.pop("arrays")
            if isinstance(arrs, dict):
                array_configs.update(arrs)
            else:
                # list form: names resolved through the array registry
                # (reference instrument configs, e.g. apex.yml "arrays: [apex/saboca]")
                from ..array import ARRAY_CONFIGS

                for entry in arrs:
                    if isinstance(entry, str):
                        if entry not in ARRAY_CONFIGS:
                            raise KeyError(
                                f"Unknown array '{entry}' (known: {sorted(ARRAY_CONFIGS)})."
                            )
                        array_configs[entry] = ARRAY_CONFIGS[entry]
                    else:
                        array_configs[entry.get("name", f"array-{len(array_configs)}")] = entry
        arrays = [
            cfg if isinstance(cfg, Array) else Array.from_config({"name": key, **cfg})
            for key, cfg in array_configs.items()
        ]
        return cls(arrays=arrays, name=name, **c)

    @property
    def dets(self) -> Array:
        if self._dets is None:
            self._dets = self.arrays.combine()
        return self._dets

    @property
    def bands(self):
        return self.dets.bands

    @property
    def n_dets(self) -> int:
        return self.dets.n

    @property
    def field_of_view(self):
        return self.dets.field_of_view

    def __getattr__(self, attr):
        dets = self.__dict__.get("_dets")
        if attr.startswith("_"):
            raise AttributeError(attr)
        try:
            return getattr(self.dets, attr)
        except AttributeError:
            raise AttributeError(attr) from None

    def __repr__(self):
        band_summary = ", ".join(self.bands.names)
        return (
            f"Instrument({self.name}):\n"
            f"  n_dets: {self.n_dets}\n"
            f"  field of view: {self.field_of_view!r}\n"
            f"  bands: [{band_summary}]\n"
            f"  arrays: {[a.name for a in self.arrays]}"
        )


def get_instrument(name: str = None, **kwargs) -> Instrument:
    if name is None:
        # instrument assembled purely from kwargs, e.g.
        # get_instrument(array={...}) (reference instrument/__init__.py:44-47)
        return Instrument.from_config(kwargs)
    low = name.lower()
    # key matches take precedence over alias matches so an instrument
    # named after another's alias always resolves to itself
    for key, config in INSTRUMENT_CONFIGS.items():
        if low == key.lower():
            return Instrument.from_config({**config, **kwargs}, name=key)
    for key, config in INSTRUMENT_CONFIGS.items():
        if low in [a.lower() for a in config.get("aliases", [])]:
            return Instrument.from_config({**config, **kwargs}, name=key)
    raise InvalidInstrumentError(name, valid=all_instruments)


def get_instrument_config(name: str) -> dict:
    """Raw config dict for a named instrument (reference
    maria/instrument/__init__.py:50-54)."""
    for key, config in INSTRUMENT_CONFIGS.items():
        if name == key or name.lower() in [a.lower() for a in config.get("aliases", [])] or name.lower() == key.lower():
            return dict(config)
    raise KeyError(f"'{name}' is not a valid instrument name (known: {all_instruments}).")

# columns shown in instrument tables (reference: instrument/__init__.py:36)
INSTRUMENT_DISPLAY_COLUMNS = ["description"]


def _build_instrument_data():
    from ..utils import require

    pd = require("pandas")

    return pd.DataFrame(INSTRUMENT_CONFIGS).T.reindex(columns=INSTRUMENT_DISPLAY_COLUMNS + ["aliases"])


# reference parity (instrument/__init__.py:57): browsable table;
# a DataFrame view, built on first use since pandas is optional
def __getattr__(name):
    if name == "instrument_data":
        return _build_instrument_data()
    raise AttributeError(name)
