"""The platform the program runs on, and every choice that depends on it.

Each gate names one step with two implementations; `GATES` says which
one each platform takes by default. The GPU column was decided by
timing both sides on an H100 at the steps' real shapes (`chip_smoke.py`
phase `gates`; the numbers are in PERF.md, "Bring-up measurements").
The CPU column keeps the side the CPU tests were tuned on. A platform
that is not in the table is an error, not a default.
"""

from __future__ import annotations

import os

import jax

# gate -> {platform: take the first-named side?}; on the H100 every
# first-named side measured slower than the plain one (PERF.md)
GATES = {
    # the matmul DFT of ops/fft.py instead of jnp.fft
    "matmul_fft": {"cpu": False, "gpu": False},
    # the banded noise stage fused into one matmul with the TOD total
    # (noise/dft.py) instead of per-band spectral fields
    "noise_total_matmul": {"cpu": False, "gpu": False},
    # streamed binning by blocked one-hot contractions with resident run
    # plans (ops/binning_runs.py) instead of scatter-adds
    "stream_blocked_binning": {"cpu": False, "gpu": False},
    # the ML mapper's pointing by blocked plans instead of segment-sums
    "ml_blocked_pointing": {"cpu": False, "gpu": False},
}


def platform() -> str:
    """The platform of the default device: 'cpu' or 'gpu'."""
    return jax.default_backend()


def use(gate: str, on: str = None) -> bool:
    """Whether `gate` takes its first-named side on platform `on`
    (default: the running platform)."""
    on = on or platform()
    sides = GATES[gate]
    if on not in sides:
        raise ValueError(f"no '{gate}' choice for platform '{on}' (known: {sorted(sides)})")
    return sides[on]


def memory_budget(fraction: float, cpu_bytes: float) -> float:
    """Bytes a working set may take: `fraction` of the default device's
    memory limit on an accelerator, the constant `cpu_bytes` on the CPU
    (whose host memory other processes share)."""
    if platform() == "cpu":
        return cpu_bytes
    return fraction * jax.devices()[0].memory_stats()["bytes_limit"]


# the compile cache's directory when JAX_COMPILATION_CACHE_DIR is unset:
# fixed, inside the checkout, and listed in .gitignore
DEFAULT_COMPILE_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and
    nothing else is set. Otherwise the cache goes to DEFAULT_COMPILE_CACHE:
    a fixed path, since the path is part of what a later run must find."""
    directory = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if directory:
        return directory
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE
