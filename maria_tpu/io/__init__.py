"""I/O: config loading, data cache, repr helpers
(reference: maria/io/__init__.py, io/parsing.py, io/logging.py)."""

from __future__ import annotations

import json
import logging

import numpy as np

from .caching import fetch, get_cache_dir, register_generator, set_cache_dir  # noqa: F401

logger = logging.getLogger("maria_tpu")

DEFAULT_TIME_FORMAT = "YYYY-MM-DD HH:mm:ss"
DEFAULT_BAR_FORMAT = "{desc}: |{bar}| {n_fmt}/{total_fmt} {rate_fmt} {elapsed}<{remaining}"


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def read_yaml(path: str) -> dict:
    """A user's YAML config; the packaged registries are JSON."""
    from ..utils import require

    yaml = require("yaml", "pyyaml")
    with open(path) as f:
        return yaml.safe_load(f) or {}


def flatten_config(config: dict, delimiter: str = "/") -> dict:
    """Recursively flatten nested namespaces into delimited keys, e.g.
    {'act': {'pa4': {'f150': {...}}}} -> {'act/pa4/f150': {...}}.
    A node is a namespace (not a leaf config) iff all its values are dicts
    (reference: maria/io/parsing.py)."""
    flat = {}
    for key, entry in config.items():
        if isinstance(entry, dict) and entry and all(isinstance(v, dict) for v in entry.values()):
            for inner_key, inner in flatten_config(entry, delimiter).items():
                flat[f"{key}{delimiter}{inner_key}"] = inner
        else:
            flat[key] = entry
    return flat


def humanize(x, units) -> str:
    """Value + units with the best SI prefix for display (reference
    maria/io/repr.py:6-7)."""
    from ..units import Quantity

    return str(Quantity(x, units=units))


def leftpad(thing, n: int = 2, char: str = " ") -> str:
    """Indent every line of str(thing) by n chars (reference
    maria/io/repr.py:14-15)."""
    return "\n".join(n * char + line for line in str(thing).splitlines())


def repr_phi_theta(phi, theta, frame_name: str = "az/el") -> str:
    return f"{np.degrees(float(phi)):.02f}°/{np.degrees(float(theta)):.02f}° ({frame_name})"


def repr_lat_lon(lat, lon) -> str:
    lat_deg, lon_deg = np.degrees(float(lat)), np.degrees(float(lon))
    ns = "N" if lat_deg >= 0 else "S"
    ew = "E" if lon_deg >= 0 else "W"
    return f"{abs(lat_deg):.03f}°{ns} {abs(lon_deg):.03f}°{ew}"


from ..utils import humanize_time  # noqa: E402,F401
