"""Time full-sky IQU CMB synthesis (docs-parity item: the reference's
`generate_cmb(nside=4096)` one-liner runs through healpy's C core;
docs/source/usage/inputs/cmb.rst).

Paths:
  - native C++ OpenMP recursion kernels (default when compiled) — the
    practical route on a multicore host;
  - the device lax.scan SHT (MARIA_TPU_SHT_NATIVE=0) — the accelerator
    route.

Prints ONE JSON line with the wall time. The native run is CPU-bound by
construction; pass --scan on a machine with an accelerator to drive the
device path.

Usage: python tools/bench_cmb_synthesis.py [--nside 4096] [--lmax L] [--scan]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=4096)
    ap.add_argument("--lmax", type=int, default=None)
    ap.add_argument("--scan", action="store_true", help="force the device lax.scan path")
    args = ap.parse_args()

    if args.scan:
        os.environ["MARIA_TPU_SHT_NATIVE"] = "0"

    import jax

    from maria_tpu.backend import enable_compile_cache
    from maria_tpu.cmb import generate_cmb
    from maria_tpu.healpix import native

    enable_compile_cache()
    path = "jax-scan" if args.scan or not native.available() else "native-openmp"
    t0 = time.time()
    cmb = generate_cmb(nside=args.nside, lmax=args.lmax, seed=0)
    import numpy as np

    d = np.asarray(cmb.data)
    elapsed = time.time() - t0
    print(json.dumps({
        "metric": f"IQU CMB synthesis wall time (nside={args.nside}, lmax={args.lmax or 'default'})",
        "value": round(elapsed, 2),
        "unit": "s",
        "path": path,
        "platform": jax.default_backend(),
        "threads": os.cpu_count(),
        "T_std_K": round(float(d[0].std()), 8),
        "finite": bool(np.isfinite(d).all()),
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — always one JSON line
        import traceback

        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": "IQU CMB synthesis wall time", "value": None,
                          "error": f"{type(e).__name__}: {e}"[:300]}))
        sys.exit(0)
