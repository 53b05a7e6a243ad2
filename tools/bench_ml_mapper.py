"""ML mapper benchmark: time per CG iteration and time-to-solution at
MUSTANG-2 scale, on the default jax device.

The maximum-likelihood mapper solves (P^T N^-1 P) m = P^T N^-1 d with
Jacobi-preconditioned CG; each CG step applies the FFT noise weighting
to every TOD block (the hot op, reference maria/mappers/ml_mapper.py:
487-535 — there torch on 16 CPU threads). This script reports:

  - setup_s: pointing matrices + noise-model build
  - cg_iter_ms: marginal wall time per CG iteration (timed over the
    second epoch so the jit compile of the PNP closure is excluded)
  - time_to_solution_s: full fit() wall time (2 epochs x 50 iters)

Prints ONE JSON line. Runs on whatever the default platform is; set
JAX_PLATFORMS=cpu for a CPU run.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    from maria_tpu.backend import enable_compile_cache

    enable_compile_cache()
    import jax
    import numpy as np

    import maria_tpu
    from maria_tpu.mappers import MaximumLikelihoodMapper
    from maria_tpu.plan import Planner

    t0 = time.time()
    input_map = maria_tpu.map.get("big_cluster", center=(150.0, 10.0))
    plans = Planner(target=(150.0, 10.0), site="GBT").generate_plans(
        start_time=1.75e9, horizon_days=2, total_duration=60, chunk_duration=60,
        scan_pattern="daisy", scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50,
    )
    sim = maria_tpu.Simulation(
        instrument="MUSTANG-2", plans=plans[0], site="GBT",
        atmosphere="2d", noise=True, map=input_map, seed=2,
    )
    tod = sim.run()[0]
    t_sim = time.time() - t0

    t0 = time.time()
    mapper = MaximumLikelihoodMapper(
        [tod], center=(150.0, 10.0), width=np.degrees(input_map.width),
        resolution=np.degrees(input_map.resolution),
        frame="ra/dec", units="K_RJ", n_epochs=1, n_cg_iters=10,
    )
    # warm-up epoch: compiles the PNP/noise closures
    mapper.fit()
    t_setup = time.time() - t0

    # marginal CG cost: two fits differing only in iteration count
    def timed_fit(iters):
        t = time.time()
        mapper.fit(epochs=1, steps_per_epoch=iters)
        return time.time() - t

    t_small = min(timed_fit(10) for _ in range(2))
    t_large = min(timed_fit(60) for _ in range(2))
    cg_iter_ms = 1e3 * (t_large - t_small) / 50

    t0 = time.time()
    mapper.fit(epochs=2, steps_per_epoch=50)
    t_solution = time.time() - t0

    n_det, n_t = tod.shape
    print(json.dumps({
        "metric": "ML mapper CG iteration (MUSTANG-2 60s daisy, FFT noise weighting)",
        "value": round(cg_iter_ms, 3),
        "unit": "ms/iter",
        "platform": jax.default_backend(),
        "n_det": int(n_det),
        "n_t": int(n_t),
        "n_pix": int(mapper.n_m),
        "sim_s": round(t_sim, 2),
        "setup_warmup_s": round(t_setup, 2),
        "time_to_solution_s": round(t_solution, 2),
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — always emit one JSON line
        import traceback

        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": "ML mapper CG iteration", "value": None,
                          "error": f"{type(e).__name__}: {e}"[:300]}))
        sys.exit(0)
