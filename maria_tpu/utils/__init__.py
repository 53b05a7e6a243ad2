"""Generic numerics. Rule inherited from the reference (maria/utils/__init__.py:3):
nothing in here imports from other maria_tpu modules (except functions/constants).
"""

from __future__ import annotations

import time as _time
from datetime import datetime, timezone

import numpy as np
import scipy as sp

from .linalg import fast_psd_inverse, generate_spatial_basis, pointing_indices_and_weights  # noqa: F401
from .rotations import (  # noqa: F401
    compute_aligning_transform,
    principal_angle_2d,
    rotation_matrix_2d,
    rotation_matrix_3d,
)

__all__ = [
    "compute_diameter",
    "require",
    "get_utc_day_hour",
    "get_utc_year_day",
    "grouper",
    "humanize_time",
    "fast_psd_inverse",
    "generate_spatial_basis",
    "pointing_indices_and_weights",
    "compute_aligning_transform",
    "rotation_matrix_2d",
    "rotation_matrix_3d",
    "principal_angle_2d",
]


def require(module: str, package: str = None):
    """Import an optional dependency, or raise an ImportError that names
    the package to install. The simulation path needs none of them."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"this feature needs the optional package '{package or module}' "
            f"(pip install {package or module}, or maria_tpu[extras])"
        ) from e


def compute_diameter(points, lazy=False, MAX_SAMPLE_SIZE: int = 10000) -> float:
    """Diameter of a point cloud via its convex hull
    (reference: maria/utils/__init__.py:57)."""
    points = np.atleast_2d(points)
    if len(points) < 2:
        return 0.0
    if lazy or len(points) > MAX_SAMPLE_SIZE:
        index = np.random.default_rng(0).choice(len(points), size=MAX_SAMPLE_SIZE, replace=True)
        points = points[index]
    dims_vary = np.ptp(points, axis=0) > 0
    if dims_vary.sum() == 0:
        return 0.0
    if dims_vary.sum() == 1:
        return float(np.ptp(points[:, dims_vary]))
    try:
        hull = sp.spatial.ConvexHull(points[:, dims_vary])
        vertices = points[hull.vertices][:, dims_vary]
    except sp.spatial.QhullError:
        vertices = points[:, dims_vary]
    d2 = np.square(vertices[:, None] - vertices[None]).sum(axis=-1)
    return float(np.sqrt(d2.max()))


def get_utc_day_hour(t: float) -> float:
    dt = datetime.fromtimestamp(float(t), tz=timezone.utc)
    return dt.hour + dt.minute / 60 + dt.second / 3600 + dt.microsecond / 3.6e9


def get_utc_year_day(t: float) -> float:
    dt = datetime.fromtimestamp(float(t), tz=timezone.utc)
    return float(dt.timetuple().tm_yday - 1) + get_utc_day_hour(t) / 24


def humanize_time(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{1e6 * seconds:.0f} µs"
    if seconds < 1:
        return f"{1e3 * seconds:.0f} ms"
    if seconds < 60:
        return f"{seconds:.02f} s"
    minutes, s = divmod(seconds, 60)
    if minutes < 60:
        return f"{int(minutes)}m{s:02.0f}s"
    hours, m = divmod(minutes, 60)
    return f"{int(hours)}h{int(m):02d}m{s:02.0f}s"


def grouper(iterable, n):
    out = []
    buf = []
    for x in iterable:
        buf.append(x)
        if len(buf) == n:
            out.append(buf)
            buf = []
    if buf:
        out.append(buf)
    return out


class Timer:
    """Context-manager phase timer (duration-logging parity with the
    reference's log_duration, maria/io/logging.py:10)."""

    def __init__(self, logger=None, message: str = ""):
        self.logger = logger
        self.message = message

    def __enter__(self):
        self.start = _time.monotonic()
        return self

    def __exit__(self, *exc):
        self.duration = _time.monotonic() - self.start
        if self.logger is not None:
            self.logger.debug(f"{self.message} in {humanize_time(self.duration)}")
        return False


# -- sexagesimal angles (reference: maria/utils/coords.py) -----------------------
def dms_to_rad(d: float = 0, m: float = 0, s: float = 0) -> float:
    """Degrees/arcminutes/arcseconds -> radians."""
    return np.radians(d + m / 60 + s / 3600)


def hms_to_rad(h: float = 0, m: float = 0, s: float = 0) -> float:
    """Hours/minutes/seconds of right ascension -> radians."""
    return np.radians(15 * (h + m / 60 + s / 3600))


def deg_to_signed_dms(x: float, precision: int = 6):
    """Degrees -> (sign, deg, arcmin, arcsec)."""
    x = round(float(x), precision)
    sign = -1 if x < 0 else 1
    mnt, sec = divmod(abs(x) * 3600, 60)
    deg, mnt = divmod(mnt, 60)
    return int(sign), int(deg), int(mnt), sec


def deg_to_signed_hms(x: float, precision: int = 6):
    """Degrees -> (sign, hours, minutes, seconds) of right ascension."""
    x = round(float(x), precision)
    sign = -1 if x < 0 else 1
    mnt, sec = divmod(abs(x) * 3600 / 15, 60)
    hrs, mnt = divmod(mnt, 60)
    return int(sign), int(hrs), int(mnt), sec


def great_circle_distance(phi1, theta1, phi2, theta2):
    """Haversine angular separation between (lon, lat) points in rad
    (reference: maria/utils/functions.py)."""
    dphi = np.asarray(phi2) - np.asarray(phi1)
    dtheta = np.asarray(theta2) - np.asarray(theta1)
    hav = (
        np.sin(dtheta / 2) ** 2
        + np.cos(theta1) * np.cos(theta2) * np.sin(dphi / 2) ** 2
    )
    return 2 * np.arcsin(np.sqrt(np.clip(hav, 0.0, 1.0)))


def hav(x):
    """Haversine (reference: maria/utils/functions.py:4-5)."""
    return (1 - np.cos(x)) / 2


# The reference's dms_to_deg/hms_to_deg apply np.radians and therefore
# RETURN RADIANS despite their names (maria/utils/coords.py:4-9); the
# aliases keep that calling convention for migrating users.
dms_to_deg = dms_to_rad
hms_to_deg = hms_to_rad

# unix timestamps carry no zone, so "local" day-hour is UTC day-hour
# (reference maria/utils/time.py:5-11 via arrow.get)
get_day_hour = get_utc_day_hour


def get_utc_year(t: float) -> int:
    """Calendar year of a unix timestamp (reference utils/time.py:21-22)."""
    return datetime.fromtimestamp(float(t), tz=timezone.utc).year


def compute_resolution_precision(x) -> int:
    """Decimal places needed to distinguish the finest spacing in x
    (reference: maria/utils/rounding.py:4-10)."""
    x = np.ravel(np.asarray(x, dtype=float))
    if x.size > 1:
        dx = np.diff(np.unique(np.r_[0.0, x]))
        positive = dx[dx > 0]
        if positive.size:
            return max(4, int(-np.floor(np.log10(positive.min()))) + 1)
    return 4


def round_sig_figs(x, sig_figs: int):
    """Round to a number of significant figures (reference:
    maria/utils/rounding.py:13-15)."""
    x = np.asarray(x, dtype=float)
    power = np.floor(np.log10(np.abs(np.where(x == 0, 1.0, x))))
    return np.round(np.round(x * 10.0**-power, sig_figs - 1) * 10.0**power, 10)


def is_numeric(val) -> bool:
    """True if val casts cleanly to float (reference utils/__init__.py:25-30)."""
    try:
        np.asarray(val).astype(float)
        return True
    except (TypeError, ValueError):
        return False


def is_integer(val):
    """Elementwise integrality test (reference utils/__init__.py:33-37)."""
    try:
        return np.asarray(val).astype(float) == np.asarray(val).astype(int)
    except (TypeError, ValueError):
        return False


def unpack_implicit_slice(key, ndims: int) -> tuple:
    """Expand an indexing key (with Ellipsis) into an explicit tuple of
    ndims slices (reference utils/__init__.py:40-53)."""
    key = key if isinstance(key, tuple) else (key,)
    explicit = []
    for s in key:
        if s is Ellipsis:
            explicit.extend([slice(None)] * (ndims + 1 - len(key)))
        else:
            explicit.append(s)
    while len(explicit) < ndims:
        explicit.append(slice(None))
    return tuple(explicit)


def regular_digitization(x, bins):
    """Bin indices for regularly spaced bins, O(1) per sample instead of
    a bisect (reference utils/__init__.py:20-22, jax.jit there; plain
    numpy here — device code uses ops.binning directly)."""
    bins = np.asarray(bins)
    dx = float(np.mean(np.diff(bins))) if len(bins) > 1 else 1.0
    return np.clip(((np.asarray(x) - (bins.min() - dx)) / dx).astype(int), 0, len(bins))


# reference-name aliases (utils/time.py exposes the bare names)
utc_day_hour = get_utc_day_hour
utc_year_day = get_utc_year_day
