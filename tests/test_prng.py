"""PRNG reproducibility: the same seed must give bitwise-identical TODs
across processes (str-hash keying was salted per process; see
ops/program.py band_key derivation), and the fused program's noise must
carry the same physics as the mixin path (NEP_per_loading term,
reference maria/sim/noise.py:33)."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

SCRIPT = """
import os, sys, hashlib
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import maria_tpu

plan = maria_tpu.get_plan("five_second_stare", start_time=1.75e9, scan_center=(60.0, 45.0))
sim = maria_tpu.Simulation(
    instrument="test/1deg", plans=plan, site="chajnantor",
    atmosphere="2d", noise=True, seed=1234,
)
tod = sim.run()[0]
sig = np.ascontiguousarray(np.asarray(tod.signal, dtype=np.float32))
print(hashlib.sha256(sig.tobytes()).hexdigest())
"""


def _run_once():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        capture_output=True, text=True, timeout=600,
        env={
            "PYTHONHASHSEED": "random",
            "PATH": "/usr/bin:/bin",
            "HOME": "/root",
            "JAX_COMPILATION_CACHE_DIR": os.environ["JAX_COMPILATION_CACHE_DIR"],
        },
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]

@pytest.mark.slow
def test_same_seed_bitwise_identical_across_processes():
    h1 = _run_once()
    h2 = _run_once()
    assert h1 == h2


@pytest.mark.slow
def test_same_seed_same_process_identical():
    import maria_tpu

    def make():
        plan = maria_tpu.get_plan("five_second_stare", start_time=1.75e9, scan_center=(60.0, 45.0))
        sim = maria_tpu.Simulation(
            instrument="test/1deg", plans=plan, site="chajnantor",
            atmosphere="2d", noise=True, seed=7,
        )
        return np.asarray(sim.run()[0].signal)

    a, b = make(), make()
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_gain_and_noise_streams_differ():
    """Gains must not share a PRNG stream with noise: two programs whose
    only difference is the gain draw must not produce correlated noise."""
    import jax
    import maria_tpu
    from maria_tpu.ops.program import build_tod_program

    sim = maria_tpu.Simulation(
        instrument="test/1deg", plans="five_second_stare", site="chajnantor",
        atmosphere="2d", noise=True, seed=3,
    )
    program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs)
    key = jax.random.key(0)
    fields, _ = jax.jit(program.fields_fn())(key, *program.example_args(key)[1:])
    noise = np.asarray(fields["noise"])

    # reconstruct the gain draw exactly as total_power_fn does
    key_gain = jax.random.split(key, 3)[2]
    gains = np.asarray(jax.random.normal(key_gain, (len(program.offsets),)))

    # the per-detector noise means and the gain draws should be
    # independent: correlation over detectors ~ 0 (bound is loose but
    # catches stream collision, which gives |rho| ~ 1 structure)
    rho = np.corrcoef(noise.mean(axis=-1), gains)[0, 1]
    assert abs(rho) < 0.5


@pytest.mark.slow
def test_fused_noise_has_loading_term():
    """With NEP_per_loading > 0, the fused program's noise amplitude must
    grow with the loading (photon noise), matching the mixin physics."""
    import jax
    import maria_tpu
    from maria_tpu.ops.program import build_tod_program

    sim = maria_tpu.Simulation(
        instrument="test/1deg", plans="five_second_stare", site="chajnantor",
        atmosphere="2d", noise=True, seed=5,
    )
    program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs)
    for b in program.bands:
        b.NEP_per_loading = 0.0
    key = jax.random.key(11)
    args = program.example_args(key)[1:]
    base = np.asarray(jax.jit(program.fields_fn())(key, *args)[0]["noise"])

    for b in program.bands:
        b.NEP_per_loading = 10.0  # huge: amplifies noise by ~10*P_W/NEP
    loaded = np.asarray(jax.jit(program.fields_fn())(key, *args)[0]["noise"])

    assert loaded.std() > 2 * base.std()
