"""Progress bars and duration logging
(reference: maria/io/logging.py:7-13 and the tqdm usage on every long
loop — atmosphere construction, turbulence generation, band loops,
mapping)."""

from __future__ import annotations

import contextlib
import logging
import time as _time

logger = logging.getLogger("maria_tpu")

DEFAULT_BAR_FORMAT = "{l_bar}{bar:16}{r_bar}"


def progress_bar(iterable=None, desc: str = "", disable: bool = True, total: int = None):
    """A tqdm bar with the package's shared format; falls back to the
    bare iterable if tqdm is unavailable."""
    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        return iterable if iterable is not None else contextlib.nullcontext()
    return tqdm(iterable, desc=desc, disable=disable, total=total, bar_format=DEFAULT_BAR_FORMAT)


@contextlib.contextmanager
def log_duration(message: str, level: int = logging.DEBUG):
    """Log `message` with the elapsed wall time on exit
    (reference io/logging.py:10)."""
    start = _time.monotonic()
    yield
    logger.log(level, f"{message} in {_time.monotonic() - start:.2f} s")


@contextlib.contextmanager
def profiler(log_dir: str = "/tmp/maria-tpu-profile", host_trace: bool = False):
    """Capture a device profile of the enclosed block (the device
    counterpart of the reference's per-phase duration logging, SURVEY §5):

        with maria_tpu.io.logging.profiler("/tmp/prof"):
            sim.run()

    Writes an XLA trace viewable in TensorBoard / Perfetto. Falls back to
    plain duration logging when jax.profiler is unavailable."""
    import jax.profiler as _jprof

    start = _time.monotonic()
    with _jprof.trace(log_dir, create_perfetto_trace=host_trace):
        yield
    logger.info(
        f"device profile captured to {log_dir} ({_time.monotonic() - start:.2f} s traced)"
    )
