"""Multi-host backend tests: the degenerate (n_proc=1) paths on the
virtual 8-device CPU mesh, plus a REAL 2-process `jax.distributed`
integration run (coordinator handshake, per-host sharded loading,
cross-process psum binning — multihost_worker.py)."""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from maria_tpu.parallel.multihost import (
    create_multihost_mesh,
    host_local_shard,
    initialize_multihost,
    is_multihost,
    process_detector_range,
)


def test_initialize_is_noop_single_process(monkeypatch):
    monkeypatch.delenv("MARIA_TPU_MULTIHOST", raising=False)
    assert initialize_multihost() is False
    assert is_multihost() is False


def test_mesh_layout_dcn_outer():
    mesh = create_multihost_mesh()
    assert mesh.axis_names == ("dcn", "det", "time")
    # single slice -> degenerate size-1 DCN axis, all 8 devices inside
    assert mesh.devices.shape[0] == 1
    assert int(np.prod(mesh.devices.shape)) == len(jax.devices())


def test_mesh_explicit_dcn_split():
    # force a 2-group DCN layout on the CPU mesh: the shape math and
    # axis ordering are what a 2-slice pod run uses
    mesh = create_multihost_mesh(dcn_size=2)
    assert mesh.devices.shape[0] == 2
    assert int(np.prod(mesh.devices.shape[1:])) == len(jax.devices()) // 2


def test_process_detector_range_covers_all_rows():
    mesh = create_multihost_mesh()
    n_det = 1000
    start, stop = process_detector_range(n_det, mesh)
    # single process addresses every device -> the whole range
    assert (start, stop) == (0, n_det)


def test_host_local_shard_matches_global():
    """host_local_shard-assembled array == device_put of the global one,
    and a sharded computation over it matches unsharded."""
    mesh = create_multihost_mesh()
    n_det, n_t = 64, 48
    rng = np.random.default_rng(0)
    full = rng.standard_normal((n_det, n_t)).astype(np.float32)

    spec = P(("dcn", "det"), "time")
    x = host_local_shard(mesh, spec, (n_det, n_t), lambda idx: full[idx])
    assert x.shape == (n_det, n_t)
    np.testing.assert_array_equal(np.asarray(x), full)

    # the binning-style reduction: per-shard partial sums + psum,
    # inserted by XLA from the sharding annotations
    @jax.jit
    def total(v):
        return jnp.sum(v * v)

    sharded = float(total(x))
    unsharded = float(total(jnp.asarray(full)))
    np.testing.assert_allclose(sharded, unsharded, rtol=1e-5)


def test_host_local_shard_fill_sees_correct_slices():
    """fill() receives global index slices; every shard lands in the
    right place even with a nontrivial (dcn x det, time) layout."""
    mesh = create_multihost_mesh(dcn_size=2)
    n_det, n_t = 32, 16
    base = np.arange(n_det * n_t, dtype=np.float32).reshape(n_det, n_t)
    calls = []

    def fill(idx):
        calls.append(idx)
        return base[idx]

    x = host_local_shard(mesh, P(("dcn", "det"), "time"), (n_det, n_t), fill)
    np.testing.assert_array_equal(np.asarray(x), base)
    assert calls, "fill was never invoked"


def test_dcn_size_must_divide():
    with pytest.raises(ValueError):
        create_multihost_mesh(dcn_size=3)


def test_two_process_integration(tmp_path):
    """The coordinator handshake and cross-process collectives, actually
    executed: 2 `jax.distributed` CPU processes x 4 devices each run the
    production fused TOD program sharded over the global ("dcn", "det",
    "time") mesh, assemble inputs via `host_local_shard` (each process's
    fill must touch only its own detector rows), bin through the
    shard_map MXU kernel with a cross-process psum, and compare both
    against single-process execution (multihost_worker.py)."""
    import json
    import socket
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "multihost_worker.py")
    with socket.socket() as s:  # a free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    outs = [tmp_path / f"worker{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(outs[i])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker hung (coordinator handshake or collective deadlock)")
        logs.append(stdout or "")
    assert all(p.returncode == 0 for p in procs), (
        f"worker rc {[p.returncode for p in procs]}\n--- worker 0 ---\n{logs[0][-4000:]}"
        f"\n--- worker 1 ---\n{logs[1][-4000:]}"
    )

    results = [json.loads(o.read_text()) for o in outs]
    assert all(r["ok"] and r["n_processes"] == 2 and r["global_devices"] == 8 for r in results)
    # disjoint per-process detector ranges covering all rows
    ranges = sorted(tuple(r["det_range"]) for r in results)
    assert ranges[0][1] == ranges[1][0] and ranges[0][0] == 0
    # both processes computed the identical replicated map
    np.testing.assert_allclose(results[0]["map_sum"], results[1]["map_sum"], rtol=1e-6)
