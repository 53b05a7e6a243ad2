"""Data cache.

The reference fetches heavy data products (atmospheric spectra, weather
quantiles, CMB spectra, example maps) from the `maria-data` GitHub repo
into a local cache (reference: maria/io/caching.py:20-169). This
framework keeps the same fetch/cache surface but synthesizes every
product it has a *generator* for (spectra, example maps, the Planck
stand-in, the height map) locally, so it never needs the network.
Downloading the reference's real products is opt-in:
`allow_downloads(True)`.
"""

from __future__ import annotations

import logging
import os
import pathlib
import tempfile
import time

logger = logging.getLogger("maria_tpu")

DEFAULT_CACHE_BASE = os.environ.get(
    "MARIA_TPU_CACHE_DIR", os.path.join(tempfile.gettempdir(), "maria-tpu-data")
)
SOURCE_BASE = "https://github.com/thomaswmorris/maria-data/raw/master"

_cache_state = {"base": DEFAULT_CACHE_BASE, "download": False}

# registered offline generators: path prefix -> callable(relative_path, destination)
_GENERATORS: dict[str, callable] = {}


def set_cache_dir(directory: str):
    _cache_state["base"] = str(directory)


def get_cache_dir() -> str:
    return _cache_state["base"]


def allow_downloads(flag: bool = True):
    """Let `fetch` download the reference's real data products. Off by
    default: the framework then never opens a network connection."""
    _cache_state["download"] = bool(flag)


def downloads_allowed() -> bool:
    return bool(_cache_state.get("download", False))


def register_generator(prefix: str, fn):
    """Register an offline generator for cache paths starting with `prefix`."""
    _GENERATORS[prefix] = fn


def cache_status(path: str, max_age: float = 30 * 86400) -> str:
    p = pathlib.Path(path)
    if not p.exists() or p.stat().st_size == 0:
        return "missing"
    if time.time() - p.stat().st_mtime > max_age:
        return "stale"
    return "ok"


def copy_file(source: str, destination: str):
    """Copy, creating the destination directory (reference
    maria/io/caching.py:24-28)."""
    import shutil

    dest_dir = os.path.dirname(destination)
    if dest_dir:
        os.makedirs(dest_dir, exist_ok=True)
    shutil.copy(source, destination)


def test_file(path: str) -> bool:
    """True if a cached file opens cleanly for its extension (reference
    maria/io/caching.py:31-47; FITS goes through our own reader)."""
    ext = str(path).rsplit(".", 1)[-1].lower()
    try:
        if ext in ("h5", "hdf5"):
            import h5py

            with h5py.File(path, "r") as f:
                f.keys()
        elif ext == "csv":
            import pandas as pd

            pd.read_csv(path)
        elif ext in ("txt", "dat"):
            with open(path) as f:
                f.read()
        elif ext == "fits":
            from .fits import read_fits

            read_fits(path)
        else:
            return os.path.getsize(path) > 0
    except Exception:  # noqa: BLE001 — any failure means a bad cache entry
        return False
    return True


def download_from_url(source_url: str, cache_path: str, chunk_size: int = 2**12, max_age: float = 30 * 86400) -> str:
    """Download a URL into the cache if missing or stale (reference
    maria/io/caching.py:75-114). Returns the local path."""
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    status = cache_status(cache_path, max_age=max_age)
    if status != "ok" and not (downloads_allowed() and _download(source_url, cache_path)):
        if status == "missing":
            raise FileNotFoundError(f"Could not download {source_url}.")
        logger.warning(f"could not refresh {source_url}; using stale cache")
    return cache_path


def _download(url: str, destination: str, timeout: float = 10.0) -> bool:
    try:
        import requests

        r = requests.get(url, timeout=timeout, stream=True)
        r.raise_for_status()
        with open(destination, "wb") as f:
            for chunk in r.iter_content(chunk_size=1 << 20):
                f.write(chunk)
        return True
    except Exception as e:  # noqa: BLE001 — any network failure falls back
        logger.debug(f"download of {url} failed: {e}")
        return False


def fetch(
    source_path: str,
    cache_path: str = None,
    max_age: float = 30 * 86400,
    refresh: bool = False,
    url_base: str = SOURCE_BASE,
    url: str = None,
) -> str:
    """Return a local path for a data product, downloading or generating it.

    Resolution order: fresh cache hit → network download (only after
    `allow_downloads(True)`) → registered offline generator → stale cache
    fallback → error. `url` overrides the
    constructed `url_base/source_path` (for products that live at a full
    URL, e.g. the Planck PLA map the reference fetches,
    maria/cmb/cmb.py:18,46).
    """
    destination = cache_path or os.path.join(get_cache_dir(), source_path)
    os.makedirs(os.path.dirname(destination), exist_ok=True)

    status = cache_status(destination, max_age=max_age)
    if status == "ok" and not refresh:
        return destination

    url = url or f"{url_base}/{source_path}"
    if downloads_allowed() and _download(url, destination):
        logger.info(f"fetched {source_path} from {url_base}")
        return destination

    # most-specific (longest) prefix wins: e.g. the planck-map generator
    # outranks the generic "maps/" family synthesizer
    for prefix in sorted(_GENERATORS, key=len, reverse=True):
        if source_path.startswith(prefix):
            logger.info(f"generating {source_path} locally (offline)")
            _GENERATORS[prefix](source_path, destination)
            return destination

    if status == "stale":
        logger.warning(f"using stale cache for {source_path}")
        return destination

    raise FileNotFoundError(
        f"Could not fetch '{source_path}': network unavailable and no offline generator registered.",
    )
