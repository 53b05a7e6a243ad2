#!/usr/bin/env python3
"""Smoke test of maria_tpu's main path on CUDA cards.

    python chip_smoke.py             # one card: every phase but `multi`
    python chip_smoke.py --chips 4   # four cards: the multi-card path only

Everything runs in this one process, except two children that stay off
the card's memory: `nvidia-smi`, and `pytest -m gpu`, which runs before
this process opens the card. Each phase prints one JSON line:

- inventory: JAX's version and devices, the card's name and power limit;
- chip_tests: the card's own tests, `pytest -m gpu`;
- mustang2: the README quick start at full size (MUSTANG-2 on the GBT,
  60 s daisy, 2-D atmosphere, noise, the `cluster` input map, then
  `BinMapper`), and the fused TOD program on the card against the same
  program and key on the CPU;
- atlast: AtLAST-50k batch (ALMA, 60 s at 50 Hz, 3-D atmosphere):
  binning through the library's run plans against `np.bincount`, and the
  program at default precision against the scan sampler under `highest`;
- noise: the plain noise stage at AtLAST-50k width, timed, with the
  bytes it must move;
- streamed: `StreamingExecutor` at 60 s against the batch program, then
  a 600 s run;
- ml: the ML mapper on the MUSTANG-2 TOD, both pointing paths;
- gates: both sides of each gate of maria_tpu/backend.py, timed warm;
- multi (--chips 4): the AtLAST-50k program sharded over a (det, time)
  mesh against one card, `bin_blocked_sharded` against `np.bincount`,
  and `extrude_time_sharded` against the sequential stream.

Times are host-clock times around `block_until_ready`, best of a few
warm runs. The last line is {"ok": true, "device": {...}}; a failed
check raises, so the script exits non-zero and prints no such line. It
refuses to run where there is no CUDA card.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Size:
    """The scenes' sizes; FULL is what the card runs, and a CPU test
    rehearses the phases at a tiny one."""

    m2_instrument: str = "MUSTANG-2"
    m2_duration: float = 60.0
    atlast_instrument: str = "AtLAST-50k"
    atlast_duration: float = 60.0
    long_duration: float = 600.0
    sample_rate: float = 50.0
    ml_iters: int = 10
    repeats: int = 3


FULL = Size()


def emit(phase: str, **fields) -> dict:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)
    return fields


def check(ok: bool, message: str):
    if not ok:
        raise AssertionError(message)


def timed(fn, *args, repeats: int = 3, **kwargs) -> float:
    """Best warm host-clock seconds of fn(*args), each ending in
    block_until_ready (the first call warms and is not counted)."""
    import jax

    jax.block_until_ready(fn(*args, **kwargs))
    best = np.inf
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - start)
    return float(best)


def rel_err(a, b) -> float:
    """rms(a - b) over the rms of b's per-row fluctuation."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = np.sqrt(np.mean((b - b.mean(axis=-1, keepdims=True)) ** 2)) or 1.0
    return float(np.sqrt(np.mean((a - b) ** 2)) / scale)


def rel_err_global(a, b) -> float:
    """rms(a - b) over the std of all of b."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (b.std() or 1.0))


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def card_lines() -> list:
    """`name, power.limit` of each card, read by nvidia-smi (a child
    that never touches JAX); empty where there is no card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()] if out.returncode == 0 else []


# -- scenes ---------------------------------------------------------------------
def m2_simulation(size: Size, seed: int = 0):
    """The README's quick start: MUSTANG-2 daisy over the cluster map."""
    import maria_tpu

    input_map = maria_tpu.map.get("cluster", center=(150.0, 10.0))
    plans = maria_tpu.Planner(target=(150.0, 10.0), site="GBT").generate_plans(
        start_time=1.75e9, horizon_days=2, total_duration=size.m2_duration,
        chunk_duration=size.m2_duration, scan_pattern="daisy",
        scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=size.sample_rate,
    )
    return maria_tpu.Simulation(
        size.m2_instrument, plans=plans[0], site="GBT", atmosphere="2d", noise=True,
        map=input_map, seed=seed,
    )


def atlast_program(size: Size, duration: float = None):
    """AtLAST-50k at ALMA: a 0.5 deg daisy, 3-D atmosphere (the
    benchmark's AtLAST scene)."""
    import bench

    return bench.build_program(
        instrument=size.atlast_instrument, site="ALMA",
        duration=duration or size.atlast_duration, radius=0.5, speed=0.25, atmosphere="3d",
        sample_rate=size.sample_rate,
    )


def without_noise(program):
    """The same program with its noise stage off (same key, same fields)."""
    quiet = copy.copy(program)
    quiet.with_noise = False
    return quiet


def run_program(program, key, device=None):
    """The fused TOD program, jitted, on `device` (default: the default)."""
    import contextlib

    import jax

    ctx = jax.default_device(device) if device is not None else contextlib.nullcontext()
    with ctx:
        if device is not None:
            key = jax.device_put(key, device)
        args = program.example_args(key)
        tables = program.device_tables()
        return jax.block_until_ready(jax.jit(program.total_power_fn())(*args, tables=tables))


def pixel_ids(obs, n: int = 128):
    """Device pixel ids (iy, ix) of every sample on an n x n grid."""
    import bench

    iy, ix, _ = bench._pixel_ids_device(None, obs, n_x=n, n_y=n)
    return iy, ix


def library_binner(iy, ix, n: int = 128):
    """The batch binner's choice (BinMapper's order): run-compressed
    plans, else det-blocked plans, else a segment-sum. Returns (path,
    jitted fn(data, *plan_args) -> (2, n, n) [sum, hits], plan_args)."""
    import jax
    import jax.numpy as jnp

    from maria_tpu.ops.binning import bin_blocked, bin_scatter, make_blocked_bin_plan_on_device
    from maria_tpu.ops.binning_runs import bin_runchunk, make_runchunk_bin_plan_on_device

    def stacked(d):
        return jnp.stack([d, jnp.ones_like(d)])

    rplan = make_runchunk_bin_plan_on_device(iy, ix, n, n)
    if rplan is not None:
        @jax.jit
        def runs(d, e, rly, rlx, origins, order, wcnt):
            return bin_runchunk(stacked(d), rplan, e_idx=e, run_ly=rly, run_lx=rlx,
                                origins=origins, order=order, wcnt=wcnt, precision="hilo")

        return "run_plan", runs, rplan.device_args()
    plan = make_blocked_bin_plan_on_device(iy, ix, n, n)
    if plan is not None:
        @jax.jit
        def blocks(d, ly, lx, origins, order):
            return bin_blocked(stacked(d), plan, ly=ly, lx=lx, origins=origins, order=order)

        return "blocked", blocks, plan.device_args()

    @jax.jit
    def scatter(d, pix):
        return jnp.stack([bin_scatter(c, pix, n * n) for c in stacked(d)]).reshape(2, n, n)

    return "scatter", scatter, (iy * n + ix,)


# -- phases ---------------------------------------------------------------------
def phase_inventory(cards: list) -> dict:
    import jax

    devices = jax.devices()
    return emit(
        "inventory", jax=jax.__version__, python=sys.version.split()[0],
        devices=[f"{d.platform}:{d.device_kind}" for d in devices], cards=cards,
        compile_cache=os.environ.get("JAX_COMPILATION_CACHE_DIR"),
    )


def phase_chip_tests() -> dict:
    """`pytest -m gpu` in a child, before this process opens the card."""
    env = {**os.environ, "JAX_PLATFORMS": ""}
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(HERE, "tests"), "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", "-x"],
        capture_output=True, text=True, env=env, cwd=HERE, timeout=600,
    )
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    # a module may skip for a missing optional package; a card test may not
    check(proc.returncode == 0 and "passed" in tail and "needs a CUDA device" not in proc.stdout,
          f"pytest -m gpu failed: {proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    return emit("chip_tests", summary=tail, seconds=time.perf_counter() - start)


def phase_mustang2(size: Size) -> dict:
    import jax

    from maria_tpu.mappers import BinMapper
    from maria_tpu.ops.program import build_tod_program

    sim = m2_simulation(size)
    start = time.perf_counter()
    tod = sim.run()[0]
    run_s = time.perf_counter() - start
    signal = np.asarray(tod.signal)
    atm = np.asarray(tod.data["atmosphere"])
    check(tod.units == "K_RJ" and np.isfinite(signal).all(), "quick-start TOD not finite K_RJ")
    # a 93 GHz sky seen from the GBT: K_RJ is calibrated above the
    # atmosphere, so a humid sky at 30 deg elevation reads a few hundred
    obs = sim.obs_list[0]
    el = float(np.degrees(np.mean(np.asarray(obs.boresight.el))))
    pwv = float(obs.atmosphere.weather.pwv)
    check(3.0 < float(atm.mean()) < 1e3, f"atmosphere at {atm.mean():.3g} K_RJ")
    check(float(atm.std()) > 0, "atmosphere does not fluctuate")
    out = BinMapper([tod], center=(150.0, 10.0), width=0.25, resolution=6e-4,
                    frame="ra/dec", units="K_RJ").run()
    weight = np.asarray(out.weight)
    check((weight > 0).any() and np.isfinite(np.nan_to_num(np.asarray(out.data))).all(),
          "quick-start map has no weight")

    # the same fused program and key on the card and on the CPU
    program = build_tod_program(obs, noise_kwargs=sim.noise_kwargs, input_map=sim.map,
                                map_kwargs=getattr(sim, "map_kwargs", {}))
    key = jax.random.key(7)
    cpu = jax.devices("cpu")[0]
    errs = {}
    for precision in ("default", "highest"):
        with jax.default_matmul_precision(precision):
            errs[precision] = rel_err(run_program(program, key), run_program(program, key, cpu))
    # TF32 (about 1e-3 relative per product) against float32 on the CPU;
    # under `highest` only op order and library differences remain
    check(errs["highest"] < 1e-3, f"card vs CPU under highest: {errs['highest']:.3g}")
    check(errs["default"] < 2e-2, f"card vs CPU at default precision: {errs['default']:.3g}")
    return emit(
        "mustang2", shape=list(signal.shape), run_s=run_s, elevation_deg=el, pwv_mm=pwv,
        atm_mean_K_RJ=float(atm.mean()),
        map_pixels_hit=int((weight > 0).sum()), card_vs_cpu_rel_err=errs,
        tolerance={"highest": 1e-3, "default": 2e-2},
    )


def phase_atlast(size: Size) -> dict:
    import jax
    import jax.numpy as jnp

    from maria_tpu.ops.binning import bin_scatter

    program, obs = atlast_program(size)
    n_det, n_t = len(program.offsets), len(program.t_fine)
    key = jax.random.key(0)
    args, tables = program.example_args(key), program.device_tables()
    start = time.perf_counter()
    compiled = jax.jit(program.total_power_fn()).lower(*args, tables=tables).compile()
    compile_s = time.perf_counter() - start
    mem = compiled.memory_analysis()
    memory = {k: getattr(mem, k, None) for k in (
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes")} if mem is not None else None
    tod_s = timed(compiled, *args, tables=tables, repeats=size.repeats)
    tod = compiled(*args, tables=tables)
    check(tod.shape == (n_det, n_t) and bool(jnp.isfinite(tod).all()), "AtLAST TOD not finite")

    # binning through the library's path against np.bincount
    iy, ix = pixel_ids(obs)
    path, bin_fn, plan_args = library_binner(iy, ix)
    binned = np.asarray(bin_fn(tod, *plan_args))
    bin_s = timed(bin_fn, tod, *plan_args, repeats=size.repeats)
    pix = iy * 128 + ix
    scatter = jax.jit(lambda d, p: bin_scatter(d, p, 128 * 128))
    scatter_s = timed(scatter, tod, pix, repeats=size.repeats)
    pix_np = np.asarray(pix).ravel()
    tod_np = np.asarray(tod, dtype=np.float64).ravel()
    hits = np.bincount(pix_np, minlength=128 * 128).reshape(128, 128)
    sums = np.bincount(pix_np, weights=tod_np, minlength=128 * 128).reshape(128, 128)
    check(np.array_equal(binned[1], hits), f"{path} hit counts differ from np.bincount")
    bin_err = float(np.abs(binned[0] - sums).max() / np.abs(sums).max())
    with jax.default_matmul_precision("highest"):  # a retrace at that precision
        bin_err_h = float(np.abs(np.asarray(bin_fn(tod, *plan_args))[0] - sums).max()
                          / np.abs(sums).max())
    # f32 sums of ~1e4 samples a pixel (bf16 hi/lo split of each run sum)
    # against float64: the accumulation class, ~1e-4 of the peak
    check(bin_err < 1e-3, f"{path} map vs np.bincount: {bin_err:.3g} of the peak")
    plan_bytes = int(sum(a.nbytes for a in plan_args))
    min_bytes = 4 * n_det * n_t + plan_bytes  # one TOD read + the plan

    # default precision and the static-hat sampler against the scan
    # sampler under `highest` (the plain path), atmosphere only
    quiet = without_noise(program)
    fast = np.asarray(run_program(quiet, key))
    os.environ["MARIA_TPU_SAMPLER_STATIC"] = "0"
    try:
        with jax.default_matmul_precision("highest"):
            plain = np.asarray(run_program(quiet, key))
    finally:
        os.environ.pop("MARIA_TPU_SAMPLER_STATIC")
    # the static-hat sampler snaps each detector's track to within 0.35
    # cells, an error in space: measured against the field's whole spread
    err = rel_err_global(fast, plain)
    check(err < 1e-2, f"default program vs plain (scan sampler, highest): {err:.3g}")
    return emit(
        "atlast", n_det=n_det, n_t=n_t, samples=n_det * n_t, compile_s=compile_s,
        tod_s=tod_s, tod_samples_per_s=n_det * n_t / tod_s, memory_analysis=memory,
        binning={"path": path, "library_s": bin_s, "scatter_s": scatter_s,
                 "min_bytes": min_bytes, "library_GB_per_s": min_bytes / bin_s / 1e9,
                 "max_rel_err": {"default": bin_err, "highest": bin_err_h},
                 "tolerance": 1e-3, "hits_exact": True},
        vs_plain={"rel_err_global": err, "rel_err_rows": rel_err(fast, plain),
                  "tolerance_global": 1e-2,
                  "precision": "default+static sampler vs highest+scan sampler"},
        peak_bytes_in_use=peak_bytes(),
    )


def phase_noise(size: Size) -> dict:
    """The plain per-band noise stage at AtLAST width: jnp.fft (cuFFT on
    the card) from one spectral draw to one f32 field."""
    import jax

    from maria_tpu.atmosphere.fourier import good_fft_size
    from maria_tpu.noise import generate_noise_with_knee

    program, _ = atlast_program(size)
    n_det, n = len(program.offsets), len(program.t_fine)
    band = program.bands[0]
    n_fft = good_fft_size(n)
    fn = jax.jit(lambda k: generate_noise_with_knee(
        k, (n_det, n), sample_rate=program.sample_rate, knee=band.knee))
    key = jax.random.key(1)
    x = fn(key)
    check(x.shape == (n_det, n) and bool(jax.numpy.isfinite(x).all()), "noise not finite")
    seconds = timed(fn, key, repeats=size.repeats)
    must_move = 2 * 4 * n_det * (n_fft // 2 + 1) + 4 * n_det * n  # draw read + field write
    return emit("noise", shape=[n_det, n], n_fft=n_fft, seconds=seconds, bytes=must_move,
                GB_per_s=must_move / seconds / 1e9)


def phase_streamed(size: Size) -> dict:
    import jax

    from maria_tpu.ops.streaming_exec import StreamingExecutor

    program, obs = atlast_program(size)
    program = without_noise(program)
    key = jax.random.key(3)
    batch = np.asarray(run_program(program, key))
    ex = StreamingExecutor(program, obs, block_tc=128)
    stream = np.concatenate([np.asarray(b) for _, b in ex.tod_blocks(key)], axis=-1)
    scale = float(np.abs(batch).max())
    tod_err = float(np.abs(stream - batch).max() / scale)
    check(tod_err < 1e-5, f"streamed TOD vs batch: {tod_err:.3g} of the peak")
    res = ex.run(key, group_size=8)
    total = float(batch.sum(dtype=np.float64))
    map_err = abs(float(res.map_sum.sum(dtype=np.float64)) - total) / abs(total)
    check(res.map_wgt.sum() == batch.size, "streamed map lost samples")
    check(map_err < 1e-5, f"streamed map total vs batch TOD total: {map_err:.3g}")

    long_program, long_obs = atlast_program(size, duration=size.long_duration)
    long_ex = StreamingExecutor(long_program, long_obs, block_tc=128)
    start = time.perf_counter()
    r = long_ex.run(key, group_size=8)
    first_s = time.perf_counter() - start
    start = time.perf_counter()
    r = long_ex.run(key, group_size=8)
    warm_s = time.perf_counter() - start
    check(np.isfinite(r.map_sum).all() and r.map_wgt.sum() == r.n_samples,
          "600 s streamed map not finite or lost samples")
    return emit(
        "streamed", tod_max_rel_err=tod_err, map_total_rel_err=map_err,
        tolerance={"tod": 1e-5, "map_total": 1e-5},
        long={"samples": r.n_samples, "first_run_s": first_s, "warm_s": warm_s,
              "samples_per_s": r.n_samples / warm_s,
              "blocked_binning": long_ex._auto_blocked(None)},
        peak_bytes_in_use=peak_bytes(),
    )


def ml_mappers(size: Size):
    """Both pointing paths of the ML mapper on one MUSTANG-2 TOD."""
    from maria_tpu.mappers import MaximumLikelihoodMapper

    tod = m2_simulation(size, seed=2).run()[0]
    kwargs = dict(center=(150.0, 10.0), width=0.25, resolution=2e-3, frame="ra/dec",
                  units="K_RJ", n_epochs=1, n_cg_iters=size.ml_iters)
    return (MaximumLikelihoodMapper([tod], mxu_pointing=False, **kwargs),
            MaximumLikelihoodMapper([tod], mxu_pointing=True, **kwargs))


def phase_ml(size: Size) -> dict:
    import jax.numpy as jnp

    import jax

    seg, blocked = ml_mappers(size)
    out_seg, out_blk = seg.fit(), blocked.fit()

    def residual(mapper, m):
        r = mapper._rhs() - mapper._apply_PNP(m)
        return float(jnp.sqrt(jnp.sum(r**2)))

    r0, r1 = residual(seg, seg.naive_map), residual(seg, seg.m)
    check(r1 < r0, f"CG residual did not fall: {r0:.4g} -> {r1:.4g}")
    def map_err(x, y):
        x = np.nan_to_num(np.asarray(x.data, dtype=np.float64))
        y = np.nan_to_num(np.asarray(y.data, dtype=np.float64))
        return float(np.abs(x - y).max() / (np.abs(y).max() or 1.0))

    err = map_err(out_blk, out_seg)
    with jax.default_matmul_precision("highest"):
        seg_h, blocked_h = ml_mappers(size)
        err_highest = map_err(blocked_h.fit(), seg_h.fit())
    check(err < 2e-3, f"blocked vs segment-sum ML maps: {err:.3g} of the peak "
                      f"(under highest: {err_highest:.3g})")
    return emit("ml", residual_naive=r0, residual_fit=r1, cg_iters=size.ml_iters,
                pointing_paths_max_rel_err={"default": err, "highest": err_highest},
                tolerance=2e-3)


def phase_gates(size: Size) -> dict:
    """Both sides of every gate at the phase's real shapes."""
    import jax
    import jax.numpy as jnp

    from maria_tpu.atmosphere.fourier import good_fft_size
    from maria_tpu.ops.fft import irfft_matmul
    from maria_tpu.ops.streaming_exec import StreamingExecutor

    gates = {}
    program, obs = atlast_program(size)
    n_det, n = len(program.offsets), len(program.t_fine)

    # matmul_fft: the noise stage's inverse real DFT
    n_fft = good_fft_size(n)
    k1, k2 = jax.random.split(jax.random.key(5))
    z = (jax.random.normal(k1, (n_det, n_fft // 2 + 1))
         + 1j * jax.random.normal(k2, (n_det, n_fft // 2 + 1))).astype(jnp.complex64)
    xla = jax.jit(lambda z: jnp.fft.irfft(z, n=n_fft))
    mm = jax.jit(lambda z: irfft_matmul(z, n_fft))
    ref = np.asarray(xla(z))
    err = rel_err(mm(z), ref)
    check(err < 1e-3, f"matmul irfft vs jnp.fft: {err:.3g}")
    gates["matmul_fft"] = {"matmul_s": timed(mm, z, repeats=size.repeats),
                           "jnp_fft_s": timed(xla, z, repeats=size.repeats),
                           "rel_err": err, "shape": [n_det, n_fft]}

    # noise_total_matmul: whole AtLAST program, noise fused or per band
    key = jax.random.key(9)
    args, tables = program.example_args(key), program.device_tables()
    signal = jax.jit(lambda k, o, a, e, t: sum(
        program._loadings(k, o, a, e, upto="signal", tables=t).values()))
    clean = np.asarray(program.draw_gains(key) * signal(*args, tables))
    sides = {}
    for mode in ("matmul", "fields"):
        os.environ["MARIA_TPU_NOISE_TOTAL"] = mode
        try:
            fn = jax.jit(program.total_power_fn())
            sides[mode] = (timed(fn, *args, tables=tables, repeats=size.repeats),
                           np.asarray(fn(*args, tables=tables)) - clean)
        finally:
            os.environ.pop("MARIA_TPU_NOISE_TOTAL")
    # two realizations of one process: the white level (first
    # differences, many independent samples) must agree closely, the
    # 1/f-dominated total within its few low modes' scatter
    noise_m, noise_f = sides["matmul"][1], sides["fields"][1]
    white = float(np.std(np.diff(noise_m)) / np.std(np.diff(noise_f)))
    ratio = float(np.std(noise_m) / np.std(noise_f))
    check(abs(white - 1) < 0.03, f"fused vs per-band white-noise ratio {white:.4f}")
    check(abs(ratio - 1) < 0.1, f"fused vs per-band noise rms ratio {ratio:.4f}")
    gates["noise_total_matmul"] = {"matmul_s": sides["matmul"][0],
                                   "fields_s": sides["fields"][0],
                                   "white_ratio": white, "rms_ratio": ratio}

    # stream_blocked_binning: resident run plans vs scatter-adds
    ex = StreamingExecutor(program, obs, block_tc=128)
    skey = jax.random.key(13)
    runs = {}
    for blocked in (True, False):
        ex.run(skey, group_size=8, mxu_binning=blocked)  # compile + plans
        start = time.perf_counter()
        runs[blocked] = (ex.run(skey, group_size=8, mxu_binning=blocked),
                         time.perf_counter() - start)
    a, b = runs[True][0], runs[False][0]
    check(np.array_equal(a.map_wgt, b.map_wgt), "blocked streamed hits differ from scatter")
    map_err = float(np.abs(a.map_sum - b.map_sum).max() / np.abs(b.map_sum).max())
    check(map_err < 1e-3, f"blocked streamed map vs scatter: {map_err:.3g} of the peak")
    gates["stream_blocked_binning"] = {"blocked_s": runs[True][1], "scatter_s": runs[False][1],
                                       "max_rel_err": map_err}

    # ml_blocked_pointing: a whole CG epoch each way
    seg, blocked_ml = ml_mappers(size)
    times = {}
    for name, mapper in (("segment_sum", seg), ("blocked", blocked_ml)):
        mapper.fit()  # compile
        start = time.perf_counter()
        out = mapper.fit()
        np.asarray(out.data)
        times[name] = time.perf_counter() - start
    gates["ml_blocked_pointing"] = {"blocked_s": times["blocked"],
                                    "segment_sum_s": times["segment_sum"],
                                    "cg_iters": size.ml_iters}
    return emit("gates", **gates)


def phase_multi(size: Size, n_devices: int = 4) -> dict:
    """The multi-card path: one process driving n_devices cards."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from maria_tpu.atmosphere.process import AutoregressiveProcess
    from maria_tpu.atmosphere.streaming import StreamingExtrusion, extrude_time_sharded
    from maria_tpu.parallel import create_mesh
    from maria_tpu.parallel.binning import bin_blocked_sharded, make_sharded_bin_plan

    check(len(jax.devices()) >= n_devices, f"need {n_devices} devices, have {len(jax.devices())}")
    mesh = create_mesh(n_devices)
    n_ds, n_ts = mesh.devices.shape
    program, obs = atlast_program(size)
    pad = program.pad_detectors(n_ds)
    n_t = len(program.t_fine)
    check(n_t % n_ts == 0, f"{n_t} samples do not split over {n_ts} time shards")
    fn = program.total_power_fn()
    key = jax.random.key(1)
    args, tables = program.example_args(key), program.device_tables()

    single_fn = jax.jit(fn)  # on the default device, the first card
    single = np.asarray(single_fn(*args, tables=tables))
    single_s = timed(single_fn, *args, tables=tables, repeats=size.repeats)
    det = NamedSharding(mesh, P("det", None))
    with mesh:
        sharded_fn = jax.jit(fn, in_shardings=(None, det, None, None, None),
                             out_shardings=NamedSharding(mesh, P("det", "time")))
        offsets = jax.device_put(args[1], det)
        tod = sharded_fn(args[0], offsets, *args[2:], tables)
        sharded_s = timed(sharded_fn, args[0], offsets, *args[2:], tables, repeats=size.repeats)
    check(len(tod.sharding.device_set) == n_devices, "the TOD is not spread over the mesh")
    tod_err = rel_err(np.asarray(tod), single)
    check(tod_err < 1e-3, f"sharded TOD vs one card: {tod_err:.3g}")

    iy, ix = (np.asarray(a) for a in pixel_ids(obs))
    if pad:  # padded detectors bin nowhere
        iy = np.pad(iy, ((0, pad), (0, 0)), constant_values=-1)
        ix = np.pad(ix, ((0, pad), (0, 0)), constant_values=-1)
    start = time.perf_counter()
    for det_block, chunk in ((512, 64), (128, 32), (64, 16)):  # wide fields need small tiles
        bin_plan = make_sharded_bin_plan(iy, ix, 128, 128, mesh, chunk=chunk, det_block=det_block)
        if bin_plan is not None:
            break
    plan_s = time.perf_counter() - start
    check(bin_plan is not None, "no sharded bin plan for the AtLAST daisy")
    binned = np.asarray(bin_blocked_sharded(tod, bin_plan, mesh))
    valid = iy >= 0
    ref = np.bincount((iy[valid] * 128 + ix[valid]).ravel(),
                      weights=np.asarray(tod, dtype=np.float64)[valid].ravel(),
                      minlength=128 * 128).reshape(128, 128)
    bin_err = float(np.abs(binned - ref).max() / np.abs(ref).max())
    check(bin_err < 1e-3, f"sharded binning vs np.bincount: {bin_err:.3g} of the peak")

    # an AR extrusion at the lowest layer's height and resolution
    layers = obs.atmosphere.layers
    res, h = float(layers.res[0]), float(layers.h[0])
    cross = np.stack([res * np.arange(24), np.full(24, h)], axis=-1)
    proc = AutoregressiveProcess(cross_section=cross, extrusion=res * np.arange(24),
                                 callback_kwargs={"nu": 5 / 6, "r0": 1e3})
    time_mesh = create_mesh(n_devices, axis_names=("time",), shape=(n_devices,))
    skey = jax.random.key(11)
    stream = np.asarray(extrude_time_sharded(proc, skey, chunk_rows=12, mesh=time_mesh))
    sequential = np.concatenate(
        [np.asarray(c) for c in StreamingExtrusion(proc, 12).run_chunks(skey, n_devices)])
    halo_err = float(np.abs(stream - sequential).max() / np.abs(sequential).max())
    check(halo_err < 1e-5, f"halo-exchange extrusion vs sequential: {halo_err:.3g}")
    return emit(
        "multi", mesh=dict(zip(mesh.axis_names, mesh.devices.shape)),
        tod_rel_err=tod_err, sharded_s=sharded_s, single_card_s=single_s,
        sharded_plan_s=plan_s, plan_tiles=[det_block, chunk], binning_max_rel_err=bin_err,
        halo_max_rel_err=halo_err,
        tolerance={"tod": 1e-3, "binning": 1e-3, "halo": 1e-5},
    )


PHASES = (phase_mustang2, phase_atlast, phase_noise, phase_streamed, phase_ml, phase_gates)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_chips = int(argv[argv.index("--chips") + 1]) if "--chips" in argv else 1
    cards = card_lines()
    if not cards:
        print("chip_smoke: no CUDA card (nvidia-smi found none)", file=sys.stderr)
        return 1
    if n_chips == 1:
        phase_chip_tests()
    import jax

    from maria_tpu.backend import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print("chip_smoke: JAX found no CUDA device", file=sys.stderr)
        return 1
    enable_compile_cache()
    phase_inventory(cards)
    if n_chips == 1:
        for phase in PHASES:
            start = time.perf_counter()
            phase(FULL)
            print(f"chip_smoke: {phase.__name__} took {time.perf_counter() - start:.1f} s",
                  file=sys.stderr, flush=True)
    else:
        phase_multi(FULL, n_chips)
    for line in cards:
        print(line)
    device = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": device.platform,
                                             "kind": device.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
