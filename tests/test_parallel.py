"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The key invariant (SURVEY.md §4): sharded execution is numerically
equivalent to single-device execution, because the PRNG is
layout-invariant and the program has no cross-detector dependencies
outside the collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import maria_tpu
from maria_tpu.ops.program import build_tod_program
from maria_tpu.parallel import create_mesh, mesh_shape_for


@pytest.fixture(scope="module")
def program():
    plan = maria_tpu.get_plan("five_second_stare", start_time=1.75e9, sample_rate=32, scan_center=(60.0, 45.0))
    sim = maria_tpu.Simulation(
        instrument="test/1deg", plans=plan, site="chajnantor", atmosphere="2d", noise=True, seed=1
    )
    return build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs)


def test_mesh_shapes():
    assert mesh_shape_for(8) in [(4, 2), (2, 4)]
    assert mesh_shape_for(1) == (1, 1)
    assert np.prod(mesh_shape_for(6)) == 6


def test_device_count():
    assert len(jax.devices()) == 8


def test_sharded_equals_unsharded(program):
    fn = program.total_power_fn()
    args = program.example_args()

    unsharded = np.asarray(jax.jit(fn)(*args))

    mesh = create_mesh(8)
    with mesh:
        sharded_fn = jax.jit(
            fn,
            in_shardings=(None, NamedSharding(mesh, P("det", None)), None, None),
            out_shardings=NamedSharding(mesh, P("det", "time")),
        )
        sharded = np.asarray(sharded_fn(*args))

    assert unsharded.shape == sharded.shape
    assert np.allclose(unsharded, sharded, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_dryrun_entrypoint():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_dryrun_gate_mixed_platform(monkeypatch):
    """With a 1-device default platform (an accelerator) plus 8
    forced host CPU devices, the dryrun must NOT run inline (scene setup
    would land on the default platform) — it must re-exec a subprocess."""
    import subprocess

    import __graft_entry__

    real_devices = jax.devices

    def fake_devices(platform=None):
        if platform is None:
            return real_devices("cpu")[:1]  # default platform: 1 chip
        return real_devices(platform)

    calls = {}

    def fake_run(cmd, **kwargs):
        calls["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(jax, "devices", fake_devices)
    monkeypatch.setattr(subprocess, "run", fake_run)
    __graft_entry__.dryrun_multichip(8)
    assert "dryrun" in calls["cmd"], "mixed-platform dryrun did not take the subprocess path"


def test_create_mesh_falls_back_to_cpu_devices(monkeypatch):
    """A default platform with too few devices is an error: create_mesh
    never borrows the CPU's devices for a mesh the caller meant for the
    accelerator, even when enough forced-host CPU devices exist."""
    import maria_tpu.parallel as par

    real_devices = jax.devices

    def fake_devices(platform=None):
        if platform is None:
            return real_devices("cpu")[:1]
        return real_devices(platform)

    monkeypatch.setattr(par.jax, "devices", fake_devices)
    with pytest.raises(ValueError, match="Requested 8 devices but only 1"):
        create_mesh(8)
    mesh = create_mesh(8, devices=real_devices("cpu"))
    assert mesh.devices.size == 8


def test_entry_compiles():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] == 217
    assert not bool(jnp.isnan(out).any())


def test_sharded_blocked_binning_matches_bincount():
    """Production multi-chip binning: per-shard MXU-blocked plans + one
    psum over the mesh must equal a host bincount to f32 tolerance."""
    from maria_tpu.parallel.binning import bin_blocked_sharded, make_sharded_bin_plan

    rng = np.random.default_rng(3)
    n_det, n_t, n_y, n_x = 32, 256, 64, 64
    # smooth scan tracks: per-detector offset + shared boresight drift
    t = np.arange(n_t)
    base_y = 32 + 20 * np.sin(2 * np.pi * t / n_t)
    base_x = 32 + 20 * np.cos(2 * np.pi * t / n_t)
    iy = np.clip(base_y[None] + rng.integers(-6, 7, (n_det, 1)), 0, n_y - 1).astype(np.int32)
    ix = np.clip(base_x[None] + rng.integers(-6, 7, (n_det, 1)), 0, n_x - 1).astype(np.int32)
    iy = np.broadcast_to(iy, (n_det, n_t)).copy()
    ix = np.broadcast_to(ix, (n_det, n_t)).copy()
    iy[-2:] = -1  # padded detector rows must contribute nothing
    data = rng.standard_normal((n_det, n_t)).astype(np.float32)

    mesh = create_mesh(8)  # (det 4, time 2)
    plan = make_sharded_bin_plan(iy, ix, n_y, n_x, mesh, chunk=32, det_block=8)
    assert plan is not None
    binned = np.asarray(bin_blocked_sharded(jnp.asarray(data), plan, mesh))

    valid = iy >= 0
    ref = np.bincount(
        (iy[valid] * n_x + ix[valid]).ravel(), weights=data[valid].ravel(),
        minlength=n_y * n_x,
    ).reshape(n_y, n_x)
    np.testing.assert_allclose(binned, ref, rtol=1e-5, atol=1e-4)
