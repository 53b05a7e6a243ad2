"""One process of the 2-process `jax.distributed` integration run.

Launched by tests/test_multihost.py (and, flag-gated, by
__graft_entry__.dryrun_multichip) as

    python multihost_worker.py <process_id> <num_processes> <port> <outfile>

with JAX_PLATFORMS=cpu and --xla_force_host_platform_device_count set in
the environment BEFORE the interpreter starts. Each process:

1. brings up `jax.distributed` through the production helper
   (`initialize_multihost` — coordinator handshake, gloo CPU
   collectives);
2. builds the ("dcn", "det", "time") mesh over the GLOBAL device set
   (2 processes x N local devices);
3. assembles the detector-sharded input via `host_local_shard`,
   asserting its `fill` is called ONLY for this process's detector rows
   (the per-host loading contract, `process_detector_range`);
4. runs the production fused TOD program jit-sharded over the global
   mesh and compares every ADDRESSABLE shard against a local
   single-device execution of the same program (sharding correctness =
   single-chip equivalence, SURVEY.md §4);
5. bins the sharded TOD through the production shard_map MXU kernel
   (`bin_blocked_sharded` — per-shard partials + cross-PROCESS psum)
   and compares the replicated map against a host bincount.

The reference has no multi-process path at all (SURVEY.md §2); this is
the distributed backend actually executing across process
boundaries, not the degenerate n_proc=1 codepath.
"""

from __future__ import annotations

import json
import os
import sys

# bench.py (the _pixel_ids helper) lives at the repo root, one level up
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, n_proc, port, outfile = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    )

    import jax

    from maria_tpu.parallel.multihost import (
        create_multihost_mesh,
        host_local_shard,
        initialize_multihost,
        is_multihost,
        process_detector_range,
    )

    assert initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_proc,
        process_id=pid,
        cluster_detection_method="deactivate",
    ), "initialize_multihost did not come up multi-process"
    assert is_multihost()
    assert jax.process_count() == n_proc, jax.process_count()
    assert jax.process_index() == pid, (jax.process_index(), pid)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import maria_tpu
    from maria_tpu.ops.program import build_tod_program
    from maria_tpu.parallel.binning import bin_blocked_sharded, make_sharded_bin_plan

    n_global = jax.device_count()
    n_det_shards, n_time_shards = 4, n_global // 4
    mesh = create_multihost_mesh(det_time_shape=(n_det_shards, n_time_shards))
    assert mesh.axis_names == ("dcn", "det", "time")

    # --- scene (identical on every process: same config, same seed) ----
    plan = maria_tpu.get_plan(
        "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0),
        frame="az/el", duration=12.0, sample_rate=20.0,
    )
    sim = maria_tpu.Simulation(
        instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d",
        noise=True, seed=7,
    )
    obs = sim.obs_list[0]
    program = build_tod_program(obs, noise_kwargs=sim.noise_kwargs)
    pad = program.pad_detectors(n_det_shards)
    n_det, n_t = len(program.offsets), len(program.t_fine)
    assert n_t % n_time_shards == 0, (n_t, n_time_shards)

    fn = program.total_power_fn()
    args = program.example_args()
    tables = program.device_tables()

    # --- local single-device reference ---------------------------------
    with jax.default_device(jax.local_devices()[0]):
        reference = np.asarray(jax.jit(fn)(*args, tables=tables))
    assert np.isfinite(reference).all()

    # --- per-host loading: fill only sees this process's rows ----------
    lo, hi = process_detector_range(n_det, mesh)
    assert 0 <= lo < hi <= n_det
    assert (hi - lo) * n_proc <= n_det + n_det_shards  # a proper subset
    offsets_np = np.asarray(args[1])
    fill_rows: list[tuple[int, int]] = []

    def fill_offsets(idx):
        r = idx[0]
        fill_rows.append((r.start or 0, r.stop if r.stop is not None else n_det))
        return offsets_np[idx]

    offsets = host_local_shard(
        mesh, P(("dcn", "det"), None), offsets_np.shape, fill_offsets
    )
    assert fill_rows, "host_local_shard never called fill"
    assert all(lo <= a and b <= hi for a, b in fill_rows), (
        f"process {pid} fill saw rows outside its range {lo, hi}: {fill_rows}"
    )

    def replicated(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, NamedSharding(mesh, P()), lambda idx: x[idx]
        )

    # --- sharded TOD over the global mesh ------------------------------
    tod_spec = P(("dcn", "det"), "time")
    with mesh:
        sharded_fn = jax.jit(
            fn,
            in_shardings=(
                NamedSharding(mesh, P()),
                NamedSharding(mesh, P(("dcn", "det"), None)),
                NamedSharding(mesh, P()),
                NamedSharding(mesh, P()),
                NamedSharding(mesh, P()),
            ),
            out_shardings=NamedSharding(mesh, tod_spec),
        )
        tod = sharded_fn(
            args[0], offsets, replicated(args[2]), replicated(args[3]),
            jax.tree.map(replicated, tables),
        )
        tod.block_until_ready()

    for shard in tod.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(shard.data), reference[shard.index], rtol=1e-4, atol=1e-5,
            err_msg=f"process {pid}: sharded TOD shard {shard.index} differs "
                    "from single-device execution",
        )

    # --- cross-process psum binning ------------------------------------
    import bench

    n_x = n_y = 64
    pix_ids, _ = bench._pixel_ids(program, obs, n_x=n_x, n_y=n_y)
    iy, ix = pix_ids // n_x, pix_ids % n_x
    if pad:
        iy = np.pad(iy, ((0, pad), (0, 0)), constant_values=-1)
        ix = np.pad(ix, ((0, pad), (0, 0)), constant_values=-1)
    plan_b = make_sharded_bin_plan(iy, ix, n_y, n_x, mesh, chunk=32, det_block=64)
    assert plan_b is not None
    binned = bin_blocked_sharded(tod, plan_b, mesh)
    binned.block_until_ready()
    local_map = np.asarray(binned.addressable_shards[0].data)

    valid = iy >= 0
    ref_map = np.bincount(
        (iy[valid] * n_x + ix[valid]).ravel(), weights=reference[valid].ravel(),
        minlength=n_y * n_x,
    ).reshape(n_y, n_x)
    np.testing.assert_allclose(
        local_map, ref_map, rtol=1e-4, atol=1e-3 * max(1.0, np.abs(ref_map).max()),
        err_msg=f"process {pid}: cross-process psum binning differs from bincount",
    )

    with open(outfile, "w") as f:
        json.dump({
            "ok": True,
            "process": pid,
            "n_processes": jax.process_count(),
            "local_devices": jax.local_device_count(),
            "global_devices": n_global,
            "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
            "det_range": [lo, hi],
            "fill_rows": fill_rows,
            "tod_shape": list(tod.shape),
            "map_sum": float(local_map.sum()),
        }, f)
    print(f"multihost worker {pid}/{n_proc} OK", flush=True)


if __name__ == "__main__":
    main()
