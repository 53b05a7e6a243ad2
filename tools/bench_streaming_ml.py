"""Streamed ML map-making benchmark: AtLAST-50k x 600 s (a long
observation; its batch program needs ~20 GB of fine-rate temporaries)
ML-mapped through StreamingMLMapper over StreamingExecutor blocks.

Reports setup, naive-map, per-pass and CG timings plus map sanity.
Prints ONE JSON line; one process per device.

Usage: timeout 3000 python tools/bench_streaming_ml.py
       [--duration 600] [--epochs 1] [--iters 10] [--cpu-smoke]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu-smoke", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu_smoke:
        jax.config.update("jax_platforms", "cpu")
    from maria_tpu.backend import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    import bench
    from maria_tpu.mappers.streaming_ml import StreamingMLMapper
    from maria_tpu.ops.streaming_exec import StreamingExecutor

    t0 = time.time()

    def stamp(msg):
        print(f"[sml +{time.time()-t0:.0f}s] {msg}", file=sys.stderr, flush=True)

    if args.cpu_smoke:
        program, obs = bench.build_program(duration=min(args.duration, 30.0))
    else:
        program, obs = bench.build_program(
            instrument="AtLAST-50k", site="ALMA", duration=args.duration,
            radius=0.5, speed=0.25, atmosphere="3d",
        )
    stamp("program built")
    ex = StreamingExecutor(program, obs, block_tc=128 if not args.cpu_smoke else 16)
    stamp(f"executor set up ({ex.n_blocks} blocks)")

    mapper = StreamingMLMapper(
        ex, n_epochs=args.epochs, n_cg_iters=args.iters,
        use_runs=None if not args.cpu_smoke else False,
    )
    t_fit = time.time()
    m = mapper.fit(jax.random.key(0))
    fit_s = time.time() - t_fit
    out = {
        "platform": jax.default_backend(),
        "duration_s": args.duration,
        "n_samples": ex.n_real_det * ex.n_t,
        "n_blocks": ex.n_blocks,
        "epochs": args.epochs,
        "cg_iters": args.iters,
        "use_runs": mapper.use_runs,
        "fit_s_incl_compile": round(fit_s, 1),
        "map_finite": bool(np.isfinite(m).all()),
        "map_std": float(m.std()),
        "covered_pix": int((mapper.hits > 0).sum()),
    }
    # warm second fit: the steady-state cost (same key -> same TOD)
    t_fit = time.time()
    mapper.fit(jax.random.key(0))
    out["fit_s_warm"] = round(time.time() - t_fit, 1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
