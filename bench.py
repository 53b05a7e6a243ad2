"""Benchmark: TOD synthesis + binning throughput (detector x time samples / s).

Legs, all in this one process on the default device:

- headline: MUSTANG-2 on GBT, 60 s daisy, 2-D turbulence, noise, gains
  and map binning, end to end on the device;
- config-b: AtLAST-50k at ALMA, 60 s at 50 Hz, 3-D turbulence, the same
  pipeline;
- streamed: AtLAST-50k x 600 s through `StreamingExecutor`;
- stages: the headline program's per-stage times;
- cpu-baseline: a single-process numpy implementation of the reference's
  algorithm (AR extrusion, scipy interpolation, cubic upsample), timed
  on the host CPU and reported as a CPU number.

Device times are host-clock times around work that ends in a readback,
compilation excluded. The benchmark refuses to run when JAX finds no
accelerator.

Usage: python bench.py [--legs headline,config-b,streamed,stages,cpu-baseline]
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

DURATION_S = 60.0
SAMPLE_RATE = 50.0
LEGS = ("headline", "config-b", "streamed", "stages", "cpu-baseline")


def build_program(
    instrument="MUSTANG-2", site="GBT", duration=DURATION_S, radius=0.083, speed=0.017,
    atmosphere="2d", sample_rate=SAMPLE_RATE,
):
    import maria_tpu
    from maria_tpu.ops.program import build_tod_program

    plan = maria_tpu.get_plan(
        "daisy_5arcmin_60s",
        start_time=1.75e9,
        scan_center=(150.0, 41.0),
        frame="az/el",
        duration=duration,
        sample_rate=sample_rate,
        scan_options={"radius": radius, "speed": speed},
    )
    sim = maria_tpu.Simulation(
        instrument=instrument, plans=plan, site=site, atmosphere=atmosphere, noise=True, seed=0
    )
    return build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs), sim.obs_list[0]


def _pixel_ids(program, obs, n_x: int = 128, n_y: int = 128):
    """Static flattened map-pixel ids per (detector, fine-time) sample —
    pointing is known before the run, so binning inside the benched
    program is a segment-sum over precomputed ids (host setup, untimed)."""
    from maria_tpu.coords.transforms import phi_theta_to_offsets
    from maria_tpu.tod.tod import Pointing

    az, el = Pointing(obs.boresight, obs.offsets, obs.q).det_azel()
    pt = np.stack([np.asarray(az), np.asarray(el)], axis=-1)
    c_az = float(np.mean(np.asarray(obs.boresight.az)))
    c_el = float(np.mean(np.asarray(obs.boresight.el)))
    offs = np.asarray(phi_theta_to_offsets(pt, c_az, c_el))
    half = np.abs(offs).max() * 1.02 + 1e-8
    res = 2 * half / n_x
    ix = np.clip(((offs[..., 0] + half) / res).astype(np.int32), 0, n_x - 1)
    iy = np.clip(((offs[..., 1] + half) / res).astype(np.int32), 0, n_y - 1)
    return iy * n_x + ix, n_x * n_y


def _pixel_ids_device(program, obs, n_x: int = 128, n_y: int = 128):
    """Device-side `_pixel_ids`: returns (iy, ix) int32 DEVICE arrays.

    The host path materializes (n_det, n_t) float64 pointing and walks
    it ~10 times on one core (tens of minutes at AtLAST scale). Here the
    pointing -> offsets -> pixel-index chain runs jitted on device; the
    host reads back one scalar (the field half-width)."""
    import jax
    import jax.numpy as jnp

    from maria_tpu.coords.transforms import offsets_to_phi_theta, phi_theta_to_offsets

    offsets = jnp.asarray(np.asarray(obs.offsets)[:, None, :], jnp.float32)
    bs_az = jnp.asarray(np.asarray(obs.boresight.az), jnp.float32)
    bs_el = jnp.asarray(np.asarray(obs.boresight.el), jnp.float32)
    c_az = float(np.mean(np.asarray(obs.boresight.az)))
    c_el = float(np.mean(np.asarray(obs.boresight.el)))

    @jax.jit
    def _offs(offsets, bs_az, bs_el):
        pt = offsets_to_phi_theta(offsets, bs_az, bs_el)
        offs = phi_theta_to_offsets(pt, c_az, c_el)
        return offs, jnp.abs(offs).max()

    offs, half_d = _offs(offsets, bs_az, bs_el)
    half = float(half_d) * 1.02 + 1e-8
    res = 2 * half / n_x

    @jax.jit
    def _ids(offs):
        ix = jnp.clip(((offs[..., 0] + half) / res).astype(jnp.int32), 0, n_x - 1)
        iy = jnp.clip(((offs[..., 1] + half) / res).astype(jnp.int32), 0, n_y - 1)
        return iy, ix

    iy, ix = _ids(offs)
    return iy, ix, n_x * n_y


def _executable_cost(compiled) -> dict | None:
    """XLA's own post-fusion cost model for ONE realization: flops and
    HBM bytes accessed of the chain(1) executable.

    Caveat (measured, see repo history): HLO cost analysis counts a
    `scan`/`while` BODY ONCE regardless of trip count, so any stage
    implemented as an internal scan is undercounted — flops/bytes here
    are a LOWER bound, and the derived speed-of-light fraction is
    therefore conservative (true utilization >= reported)."""
    try:
        ca = compiled.cost_analysis()
        d = ca[0] if isinstance(ca, (list, tuple)) else ca
        flops = float(d.get("flops", 0.0))
        hbm_bytes = float(d.get("bytes accessed", 0.0))
        if flops <= 0 and hbm_bytes <= 0:
            return None
        return {"flops": flops, "bytes": hbm_bytes}
    except Exception:  # noqa: BLE001 — cost analysis is best-effort (backend-dependent)
        return None


def bench_device(program, obs=None, n_repeats: int = 5, k_chain: int = None,
              return_cost: bool = False, batch: int = None) -> float:
    """Samples/s of the fused jitted program on the default jax device,
    including on-device map binning of every realization when `obs` is
    given (the full atmosphere -> TOD -> binned-map pipeline of
    BASELINE.md).

    Measures pipelined throughput: one dispatch synthesizes `k_chain`
    independent TOD realizations via `lax.scan` over PRNG keys, and the
    per-TOD time is the host-clock time of that dispatch, read back to
    the host, over k. Every stage of every realization is timed — each
    scan iteration computes the full (n_det, n_t) TOD (and its binned
    map) before the reduction that keeps XLA from dropping work.
    """
    import jax
    import jax.numpy as jnp

    pix = plan = plan_args = rplan = None
    in_plan_order = False
    if obs is not None:
        from maria_tpu.ops.binning import make_blocked_bin_plan_on_device
        from maria_tpu.ops.binning_runs import make_runchunk_bin_plan_on_device

        # blocked binning, fewest one-hot rows first: run-compressed ->
        # det-blocked -> scatter as a last resort. Plans are built ON
        # DEVICE — the host path walks the (n_det, n_t) pointing ~10
        # times on one core and takes tens of minutes at AtLAST scale
        iy, ix, n_pix = _pixel_ids_device(program, obs)
        rplan = make_runchunk_bin_plan_on_device(
            iy, ix, 128, 128, order_groups=program.band_bounds())
        if rplan is not None:
            plan = rplan
            # band-stable plan: permute the program's detector axis so
            # the fused synthesis EMITS det-blocked TOD and binning
            # consumes it with zero row-gather relayout
            if program.band_bounds() is not None:
                program.permute_detectors(rplan.order[:len(program.offsets)])
                in_plan_order = True
        else:
            plan = make_blocked_bin_plan_on_device(iy, ix, 128, 128)
        if plan is None:
            pix = (iy * 128 + ix).ravel()
        else:
            # index arrays ride as jit arguments, not closure constants
            plan_args = plan.device_args()
        # free the int32 id buffers before the benched programs
        # allocate their fine-rate fields
        del iy, ix

    fn = program.total_power_fn()
    args = program.example_args()
    tables = program.device_tables()

    n_samples = len(program.offsets) * len(program.t_fine)
    if batch is None:
        # small scenes are per-op-overhead-bound (MUSTANG-2's stage
        # arrays are a few MB), so independent realizations are vmapped
        # into one fat program: arrays grow `batch`-fold and the fixed
        # per-op costs amortize. Realization count, not problem size: every TOD is
        # still fully synthesized and binned (channel-stacked).
        batch = int(np.clip((1 << 24) // max(n_samples, 1), 1, 16))
    if k_chain is None:
        # bound the chain's device working set: each iteration synthesizes
        # `batch` full (n_det, n_t) TODs, so huge arrays get a shorter
        # chain. Small programs chain deeper so the one-dispatch timing
        # dwarfs dispatch jitter.
        k_chain = int(np.clip((1 << 31) // max(4 * n_samples * batch, 1), 8, 128)) + 1

    def make_chain(k_count):
        # pix rides as an ARGUMENT, not a closure constant
        @jax.jit
        def run(key, offsets, bs_az, bs_el, pix_arg, bin_args, tables):
            def body(carry, k):
                from maria_tpu.ops.binning import bin_blocked, bin_scatter
                from maria_tpu.ops.binning_runs import bin_runchunk

                if batch > 1:
                    keys_b = jax.random.split(k, batch)
                    tod = jax.vmap(
                        lambda kk: fn(kk, offsets, bs_az, bs_el, tables=tables)
                    )(keys_b)  # (batch, n_det, n_t) — channel-stacked below
                else:
                    tod = fn(k, offsets, bs_az, bs_el, tables=tables)
                out = tod.mean()
                if rplan is not None:
                    e, rly, rlx, origins, order, wcnt = bin_args
                    binned = bin_runchunk(tod, rplan, e_idx=e, run_ly=rly, run_lx=rlx,
                                          origins=origins, order=order, wcnt=wcnt,
                                          data_in_plan_order=in_plan_order)
                    out = out + binned.max() / max(len(program.t_fine), 1)
                elif plan is not None:
                    ly, lx, origins, order = bin_args
                    binned = bin_blocked(tod, plan, ly=ly, lx=lx, origins=origins, order=order)
                    out = out + binned.max() / max(len(program.t_fine), 1)
                elif pix_arg is not None:
                    binned = bin_scatter(tod.reshape(-1, tod.shape[-1]) if batch > 1 else tod,
                                         jnp.tile(pix_arg, (batch,)) if batch > 1 else pix_arg,
                                         n_pix)
                    out = out + binned.max() / max(len(program.t_fine), 1)
                return carry + out, ()
            keys = jax.random.split(key, k_count)
            total, _ = jax.lax.scan(body, jnp.float32(0.0), keys)
            return total
        return run

    def compiled_chain(k_count):
        # AOT compile so the SAME executable is timed and cost-analyzed
        return make_chain(k_count).lower(*args, pix, plan_args, tables).compile()

    def timed(f):
        float(np.asarray(f(*args, pix, plan_args, tables)))  # warm up
        times = []
        for i in range(n_repeats):
            fresh = (jax.random.key(i + 1), *args[1:])
            start = time.perf_counter()
            float(np.asarray(f(*fresh, pix, plan_args, tables)))
            times.append(time.perf_counter() - start)
        return min(times)

    chain_k = compiled_chain(k_chain)
    t_k = timed(chain_k)
    per_tod = t_k / (k_chain * batch)
    rate = n_samples / per_tod
    if return_cost:
        # the scan body is counted ONCE by HLO cost analysis regardless
        # of trip count (see _executable_cost), so the k-chain's cost is
        # the per-ITERATION cost — divide by the realization batch to
        # get per-TOD
        cost = _executable_cost(chain_k)
        if cost and batch > 1:
            cost = {k: v / batch for k, v in cost.items()}
        return rate, cost
    return rate


def bench_stages(program, n_repeats: int = 3, k_chain: int = None, batch: int = None) -> dict:
    """Marginal per-realization device time of nested pipeline prefixes,
    reported as per-stage milliseconds:

      screens_ar_pwv : pointing + screen synthesis + AR extrusion + LOS
                       sampling to coarse-rate pwv
      bandpass_upsample : + per-band (pwv, el) power tables + time upsample
      noise          : + knee-noise FFT synthesis and gains
      (binning is reported by the main benchmark as total - fields)
    """
    import jax
    import jax.numpy as jnp

    args = program.example_args()
    tables = program.device_tables()

    # the SAME realization batching as bench_device, so per-stage times are
    # per-TOD on the same footing as the headline rate (a mismatch makes
    # the derived binning_ms nonsense)
    n_samples = len(program.offsets) * len(program.t_fine)
    if batch is None:
        batch = int(np.clip((1 << 24) // max(n_samples, 1), 1, 16))
    if k_chain is None:
        k_chain = int(np.clip((1 << 31) // max(4 * n_samples * batch, 1), 8, 128)) + 1

    def chain(stage_fn, k_count):
        @jax.jit
        def run(key, offsets, bs_az, bs_el, tables):
            def one(k):
                out = stage_fn(k, offsets, bs_az, bs_el, tables)
                vals = out.values() if isinstance(out, dict) else [out]
                return sum(jnp.sum(v) for v in vals)

            def body(carry, k):
                if batch > 1:
                    return carry + jnp.sum(jax.vmap(one)(jax.random.split(k, batch))), ()
                return carry + one(k), ()

            keys = jax.random.split(key, k_count)
            total, _ = jax.lax.scan(body, jnp.float32(0.0), keys)
            return total

        return run

    def marginal(stage_fn):
        def timed(f):
            float(np.asarray(f(*args, tables)))  # warm
            times = []
            for i in range(n_repeats):
                fresh = (jax.random.key(i + 1), *args[1:])
                start = time.perf_counter()
                float(np.asarray(f(*fresh, tables)))
                times.append(time.perf_counter() - start)
            return min(times)

        ck = chain(stage_fn, k_chain).lower(*args, tables).compile()
        return timed(ck) / (k_chain * batch)

    t_pwv = marginal(lambda k, o, a, e, tb: program._loadings(k, o, a, e, upto="pwv", tables=tb))
    t_atm = marginal(lambda k, o, a, e, tb: program._loadings(k, o, a, e, upto="atmosphere", tables=tb))
    t_all = marginal(lambda k, o, a, e, tb: program.total_power_fn()(k, o, a, e, tables=tb))
    out = {
        "screens_ar_pwv_ms": round(1e3 * max(t_pwv, 0.0), 3),
        "bandpass_upsample_ms": round(1e3 * max(t_atm - t_pwv, 0.0), 3),
        "noise_gains_ms": round(1e3 * max(t_all - t_atm, 0.0), 3),
        "fields_total_ms": round(1e3 * t_all, 3),
    }
    return out



def bench_cpu_baseline(program, obs) -> float:
    """Single-threaded numpy implementation of the same synthesis, using
    the reference's algorithm structure (AR extrusion; scipy
    interpolation; cubic upsample). Setup (covariance factorization)
    excluded from timing, mirroring the device timing which excludes
    compilation."""
    import scipy as sp

    from maria_tpu.atmosphere.process import AutoregressiveProcess
    from maria_tpu.coords.transforms import offsets_to_phi_theta

    atm = obs.atmosphere
    rng = np.random.default_rng(0)

    # setup: AR processes matching each screen's grid (not timed)
    processes = []
    for screen in atm.screens:
        if getattr(screen, "band", "full") == "coarse":
            # the fine/coarse pair covers ONE physical layer; the
            # reference algorithm models each layer once
            continue
        # the footprint-sized grid the reference AR method needs (the
        # FFT-padded screen.nx/ny would overcharge the CPU baseline)
        nx = screen.nx_needed or screen.nx
        ny = screen.ny_needed or screen.ny
        cross = np.stack([screen.ty_min + screen.res * np.arange(ny), np.full(ny, screen.h)], axis=-1)
        extrusion = screen.tx_min + screen.res * np.arange(nx)
        proc = AutoregressiveProcess(cross_section=cross, extrusion=extrusion,
                                     callback_kwargs={"nu": 5 / 6, "r0": 1e3})
        proc.compute_covariance_matrices()
        processes.append((screen, proc))

    offsets = np.asarray(program.offsets, dtype=np.float64)
    bs_az = np.asarray(program.bs_az_coarse, dtype=np.float64)
    bs_el = np.asarray(program.bs_el_coarse, dtype=np.float64)
    t_c, t_f = program.t_coarse, program.t_fine

    start = time.perf_counter()

    pt = np.asarray(offsets_to_phi_theta(offsets[:, None, :], bs_az, bs_el))
    det_az, det_el = pt[..., 0], pt[..., 1]
    el_clip = np.clip(det_el, np.radians(5), np.pi / 2)
    cot = 1 / np.tan(el_clip)
    px, py = np.sin(det_az) * cot, np.cos(det_az) * cot

    pwv = np.full(det_az.shape, program.mean_pwv)

    def screen_contribution(item):
        screen, proc = item
        # the sequential AR loop (reference process.py:191-209)
        A = np.asarray(proc.A, dtype=np.float64)
        B = np.asarray(proc.B, dtype=np.float64)
        srng = np.random.default_rng(int(1e6 * screen.h))
        n_ext = proc.n_extrusion
        n_steps = 2 * n_ext
        BUF = srng.standard_normal((n_ext + n_steps, proc.n_cross_section))
        e_idx, c_idx = proc.extrusion_sample_index, proc.cross_section_sample_index
        for b in range(n_steps - 1, -1, -1):
            BUF[b] = A @ BUF[b + e_idx + 1, c_idx] + B @ srng.standard_normal(proc.n_live_edge)
        values = sp.ndimage.gaussian_filter(BUF[:n_ext], sigma=(1.0, 1.0))

        x = screen.h * px + screen.vx * t_c
        y = screen.h * py + screen.vy * t_c
        ca, sa = np.cos(screen.angle), np.sin(screen.angle)
        tx, ty = ca * x + sa * y, -sa * x + ca * y
        interp = sp.interpolate.RegularGridInterpolator(
            (proc.extrusion, proc.cross_section[:, 0]), values,
            method="linear", bounds_error=False, fill_value=0.0,
        )
        return screen.pwv_rms * interp(np.stack([tx, ty], axis=-1))

    # screens are independent: run them on a thread pool (BLAS/scipy
    # release the GIL), so the baseline is honestly multithreaded
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(len(processes) or 1, os.cpu_count())) as pool:
        for contribution in pool.map(screen_contribution, processes):
            pwv = pwv + contribution

    loading_c = np.zeros_like(pwv)
    for band in program.bands:
        interp = sp.interpolate.RegularGridInterpolator(
            (np.asarray(band.pwv_side), np.asarray(band.el_side)), np.asarray(band.power_table)
        )
        loading_c[band.det_index] = interp(
            np.stack([pwv[band.det_index], el_clip[band.det_index]], axis=-1)
        )

    loading = sp.interpolate.interp1d(
        t_c, loading_c, axis=-1, kind="cubic", bounds_error=False, fill_value="extrapolate"
    )(t_f)

    # noise (white + pink via FFT, reference noise/generation.py:11)
    n_det, n_t = loading.shape
    noise = np.sqrt(SAMPLE_RATE) * rng.standard_normal((n_det, n_t))
    f = np.fft.rfftfreq(n_t, d=1 / SAMPLE_RATE)
    for band in program.bands:
        with np.errstate(divide="ignore"):
            w = np.sqrt(2 * SAMPLE_RATE * np.where(f > 0, (band.knee / 2) / f, 0))
        pink = np.fft.irfft(w * np.fft.rfft(rng.standard_normal((len(band.det_index), n_t))), n=n_t)
        noise[band.det_index] = 1e12 * band.NEP * (noise[band.det_index] + pink)

    total = loading * np.exp(program.gain_error * rng.standard_normal(n_det))[:, None] + noise

    # map binning (reference BinMapper: sparse matvec == bincount)
    pix_ids, n_pix = _pixel_ids(program, obs)
    binned = np.bincount(pix_ids.ravel(), weights=total.ravel(), minlength=n_pix)
    assert binned.shape[0] == n_pix

    elapsed = time.perf_counter() - start
    return total.size / elapsed


def headline() -> dict:
    program, obs = build_program()
    rate, cost = bench_device(program, obs, return_cost=True)
    return {"mustang2_samples_per_s": rate, "mustang2_xla_cost_per_tod": cost}


def config_b() -> dict:
    program, obs = build_program(
        instrument="AtLAST-50k", site="ALMA", duration=60.0, radius=0.5, speed=0.25,
        atmosphere="3d",
    )
    rate, cost = bench_device(program, obs, n_repeats=3, return_cost=True)
    return {"atlast_samples_per_s": rate, "atlast_xla_cost_per_tod": cost}


def streamed_leg() -> dict:
    """AtLAST-50k x 600 s through the production StreamingExecutor; the
    warm rate of the second and third runs."""
    import jax

    from maria_tpu.ops.streaming_exec import StreamingExecutor

    program, obs = build_program(
        instrument="AtLAST-50k", site="ALMA", duration=600.0, radius=0.5, speed=0.25,
        atmosphere="3d",
    )
    ex = StreamingExecutor(program, obs, block_tc=128)
    key = jax.random.key(0)
    r = ex.run(key, group_size=8)  # compile + warm
    times = []
    for _ in range(2):
        start = time.perf_counter()
        r = ex.run(key, group_size=8)
        times.append(time.perf_counter() - start)
    return {"streamed_600s_samples_per_s": r.n_samples / min(times),
            "streamed_blocked_binning": ex._auto_blocked(None)}


def stages_leg() -> dict:
    program, _ = build_program()
    return {"mustang2_stage_ms": bench_stages(program)}


def cpu_baseline_leg(n_repeats: int = 3) -> dict:
    """The numpy baseline on the host CPU (the program is built on the
    default device; the baseline itself is numpy/scipy)."""
    program, obs = build_program()
    rates = [bench_cpu_baseline(program, obs) for _ in range(n_repeats)]
    return {"cpu_baseline_samples_per_s": float(np.median(rates)),
            "cpu_baseline_range": [min(rates), max(rates)],
            "cpu_baseline_threads": os.cpu_count()}


_LEG_FNS = {
    "headline": headline,
    "config-b": config_b,
    "streamed": streamed_leg,
    "stages": stages_leg,
    "cpu-baseline": cpu_baseline_leg,
}


def main(legs=LEGS) -> dict:
    import jax

    from maria_tpu.backend import enable_compile_cache

    device = jax.devices()[0]
    if device.platform == "cpu":
        raise SystemExit("bench.py measures the accelerator; JAX found none")
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    result = {"device": {"platform": device.platform, "kind": device.device_kind,
                         "count": len(jax.devices()),
                         "name_power_limit": smi.stdout.strip().splitlines()[:1]}}
    for leg in legs:
        start = time.perf_counter()
        result.update(_LEG_FNS[leg]())
        result[f"{leg}_wall_s"] = time.perf_counter() - start
    return result


if __name__ == "__main__":
    legs = LEGS
    if "--legs" in sys.argv:
        legs = tuple(sys.argv[sys.argv.index("--legs") + 1].split(","))
    print(json.dumps(main(legs)))
