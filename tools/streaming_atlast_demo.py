"""Stream an AtLAST-scale observation on one device (bounded memory at
flagship scale).

A 600 s batch AtLAST-50k program needs ~20 GB of device temporaries;
observations longer than a device holds stream. This tool
builds the same 50k-detector multi-band 3-D-atmosphere scene bench.py
uses for config (b), streams it block-by-block through
StreamingExecutor, and reports wall time, throughput and the map
checksum. The reference caps the same scale claim at "in excess of
100,000" detectors on CPU (README.rst:44-46) with dask-lazy TODs
(maria/tod/tod.py:63).

Usage: python tools/streaming_atlast_demo.py [--duration 600]
       [--block-tc 32] [--group 4] [--cpu-smoke]

`--cpu-smoke` swaps in the MUSTANG-2 instrument at 60 s so the flow can
be validated on a single CPU core.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import resource
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--block-tc", type=int, default=32)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--cpu-smoke", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu_smoke:
        jax.config.update("jax_platforms", "cpu")
    from maria_tpu.backend import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    import bench
    from maria_tpu.ops.streaming_exec import StreamingExecutor

    t0 = time.time()
    if args.cpu_smoke:
        program, obs = bench.build_program(duration=min(args.duration, 60.0))
    else:
        program, obs = bench.build_program(
            instrument="AtLAST-50k", site="ALMA", duration=args.duration,
            radius=0.5, speed=0.25, atmosphere="3d",
        )
    ex = StreamingExecutor(program, obs, block_tc=args.block_tc)
    t_setup = time.time() - t0
    print(f"[{t_setup:.0f}s] scene: {ex.n_det} det x {ex.n_t} t, "
          f"{ex.n_blocks} blocks of {ex.B} fine samples "
          f"({4 * ex.n_det * ex.B / 1e9:.2f} GB per fine field-block); "
          f"platform {jax.default_backend()}", file=sys.stderr, flush=True)

    t0 = time.time()
    result = ex.run(jax.random.key(0), group_size=args.group)
    t_cold = time.time() - t0
    print(f"[+{t_cold:.0f}s] cold run done", file=sys.stderr, flush=True)

    t0 = time.time()
    result = ex.run(jax.random.key(0), group_size=args.group)
    t_warm = time.time() - t0

    n = result.n_samples
    print(json.dumps({
        "metric": "streamed AtLAST samples/s (3d atmosphere + noise + binning)",
        "value": round(n / t_warm, 1),
        "unit": "samples/s",
        "platform": jax.default_backend(),
        "n_det": ex.n_det,
        "duration_s": args.duration,
        "n_samples": n,
        "setup_s": round(t_setup, 1),
        "cold_run_s": round(t_cold, 1),
        "warm_run_s": round(t_warm, 1),
        "peak_rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        "map_hits": float(result.map_wgt.sum()),
        "finite": bool(np.isfinite(result.map).any()),
    }), flush=True)


if __name__ == "__main__":
    main()
