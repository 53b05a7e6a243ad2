"""Demonstrate bounded-memory long observations.

Runs the streaming executor on MUSTANG-2 daisy scans of increasing
duration, each in a fresh subprocess, and reports peak RSS. The fine-
rate working set is O(block) by construction, so peak memory should be
~flat in observation length (the coarse-rate fields and the screen
grow linearly but with ~upsample_ratio-times-smaller constants; a batch
run grows with every field at the fine rate).

Usage:  python tools/streaming_memory_demo.py [durations_s ...]
        python tools/streaming_memory_demo.py --child 3600   (internal)

Writes one JSON line per duration and a summary. Forces the cpu
platform by default (the point is the memory scaling); pass --device
to run on the default platform instead (then samples_per_s is the
long-observation throughput on the accelerator; the children run one
after another, so one process holds the device at a time).
"""

from __future__ import annotations

import json
import os
import resource
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

if "--device" not in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"


def child(duration: float) -> None:
    import jax

    if "--device" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    from maria_tpu.backend import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    import maria_tpu
    from maria_tpu.ops.program import build_tod_program
    from maria_tpu.ops.streaming_exec import StreamingExecutor

    t0 = time.time()
    plan = maria_tpu.get_plan(
        "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0),
        frame="az/el", duration=duration, sample_rate=50.0,
    )
    sim = maria_tpu.Simulation(
        instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True, seed=0
    )
    obs = sim.obs_list[0]
    program = build_tod_program(obs, noise_kwargs=sim.noise_kwargs)
    ex = StreamingExecutor(program, obs, block_tc=64)
    t_setup = time.time() - t0

    t0 = time.time()
    result = ex.run(group_size=16)
    t_run = time.time() - t0

    # steady-state throughput: the first run pays the one-off scan
    # compile; a second run reuses it
    t0 = time.time()
    ex.run(group_size=16)
    t_warm = time.time() - t0

    n_samples = result.n_samples
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    fine_gb_batch = 4 * n_samples * 4 / 1e9  # 4 f32 fields at the fine rate
    print(json.dumps({
        "duration_s": duration,
        "n_samples": n_samples,
        "n_blocks": ex.n_blocks,
        "block_fine_samples": ex.B,
        "peak_rss_mb": round(peak_mb, 1),
        "batch_fine_fields_gb": round(fine_gb_batch, 2),
        "setup_s": round(t_setup, 1),
        "run_s": round(t_run, 1),
        "samples_per_s": round(n_samples / t_run, 1),
        "warm_run_s": round(t_warm, 1),
        "samples_per_s_warm": round(n_samples / t_warm, 1),
        "map_hits": float(result.map_wgt.sum()),
        "finite": bool(np.isfinite(result.map).any()),
    }), flush=True)


def main(durations) -> None:
    rows = []
    for d in durations:
        child_args = [sys.executable, os.path.abspath(__file__), "--child", str(d)]
        if "--device" in sys.argv:
            child_args.append("--device")
        proc = subprocess.run(
            child_args,
            capture_output=True, text=True, timeout=7200,
        )
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("{")), None)
        if line is None:
            print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
            raise RuntimeError(f"child for duration {d} produced no JSON")
        rows.append(json.loads(line))
        print(line, flush=True)
    if len(rows) >= 2:
        first, last = rows[0], rows[-1]
        growth = last["peak_rss_mb"] / first["peak_rss_mb"]
        length = last["duration_s"] / first["duration_s"]
        print(json.dumps({
            "summary": "peak RSS growth vs observation-length growth",
            "rss_growth": round(growth, 2),
            "length_growth": round(length, 2),
            "flat": growth < 0.25 * length + 1.0,
        }))


if __name__ == "__main__":
    if "--child" in sys.argv:
        child(float(sys.argv[sys.argv.index("--child") + 1]))
    else:
        ds = [float(a) for a in sys.argv[1:] if not a.startswith("-")] or [600.0, 3600.0]
        main(ds)
