"""maria_tpu — a JAX simulator of ground-based mm/submm telescopes.

Synthesizes time-ordered data (TOD) from correlated atmospheric
turbulence, the CMB, input sky maps and instrument noise, then maps the
TODs back onto the sky — with the entire inner loop (turbulence
synthesis, line-of-sight sampling, bandpass integration, map binning)
running as jit-compiled JAX/XLA programs on the accelerator, sharded
over device meshes for large arrays.

Public API parity with the reference package (maria/__init__.py:12-21).
"""

from __future__ import annotations

import logging

from .constants import *  # noqa: F401,F403
from .errors import *  # noqa: F401,F403
from .units import Angle, Quantity  # noqa: F401

__version__ = "0.1.0"
__version_tuple__ = tuple(int(x) for x in __version__.split("."))

logger = logging.getLogger("maria_tpu")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("%(asctime)s.%(msecs)03d %(levelname)s: %(message)s", datefmt="%H:%M:%S"),
    )
    logger.addHandler(_handler)
    logger.setLevel(logging.WARNING)


def debug():
    logger.setLevel(logging.DEBUG)


def undebug():
    logger.setLevel(logging.WARNING)


from .io import fetch, set_cache_dir  # noqa: E402,F401
from .band import Band, all_bands, get_band  # noqa: E402,F401
from .array import Array, all_arrays, get_array  # noqa: E402,F401
from .instrument import Instrument, all_instruments, get_instrument  # noqa: E402,F401
from .site import Site, all_regions, all_sites, get_site  # noqa: E402,F401
from .plan import Plan, Planner, all_plans, get_plan  # noqa: E402,F401
from .map import all_maps  # noqa: E402,F401
from .map.transfer import (  # noqa: E402,F401
    TransferFunction,
    compute_transfer_function,
    plot_transfer_function,
)
from .sim import Simulation  # noqa: E402,F401
from .tod import TOD  # noqa: E402,F401
# an extension beyond the reference surface: bounded-memory long
# observations (reference: dask-lazy TOD fields, tod/tod.py:63)
from .ops.streaming_exec import StreamingExecutor  # noqa: E402,F401


def __getattr__(name):
    # the reference's site table is a DataFrame, built on first use
    # since pandas is optional
    if name == "site_data":
        from .site import _build_site_data

        return _build_site_data()
    raise AttributeError(name)

__all__ = [
    "Angle",
    "Array",
    "Band",
    "Instrument",
    "Plan",
    "Planner",
    "Quantity",
    "Simulation",
    "Site",
    "StreamingExecutor",
    "TOD",
    "TransferFunction",
    "all_arrays",
    "all_bands",
    "all_instruments",
    "all_maps",
    "all_plans",
    "all_regions",
    "all_sites",
    "compute_transfer_function",
    "debug",
    "fetch",
    "get_array",
    "get_band",
    "get_instrument",
    "get_plan",
    "get_site",
    "plot_transfer_function",
    "set_cache_dir",
    "undebug",
]
