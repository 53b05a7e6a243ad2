"""Multi-host (multi-process) backend scaffolding.

SURVEY.md §2/§5 call for a distributed backend: `jax.distributed` for
process bring-up, the fast interconnect (NVLink between the cards of a
host) for collectives within a host, the network only across hosts —
never the reference's MPI/dask layout (the reference has no multi-host
path at all; its scaling story is dask-lazy TODs in one process,
maria/tod/tod.py:63).

Design:

- **Axis layout.** The observation mesh is (det, time) within a host
  (see parallel/__init__). Across hosts we add an OUTER "dcn" axis used
  only for embarrassingly parallel work — independent TOD
  realizations, plan groups, or observation chunks — so every collective
  that touches data (the binning psum, halo ppermute) stays within a
  host, and the network carries only the final map reduction (one
  (n_y, n_x) psum per realization batch, ~100 kB: latency-tolerant by
  construction).
- **Per-host loading.** Static per-detector inputs (pointing offsets,
  spectral tables) are built or loaded only for the detector rows a
  host's addressable shards need (`host_local_shard`), so bring-up cost
  and host RSS stay O(n_det / n_hosts).
- **Degenerate single-process path.** Everything here runs (and is
  CI-tested) with one process and the virtual CPU mesh; a real
  multi-host run only changes the environment, not the code path. The multi-process
  path itself is CI-tested too: tests/test_multihost.py spawns two
  `jax.distributed` CPU processes (coordinator handshake, gloo
  collectives) and checks sharded TOD synthesis + cross-process psum
  binning against single-process execution (multihost_worker.py).

Launch recipe: one process per host drives all of that host's cards
(one host needs no initialization at all — `jax.devices()` already
lists its cards):

    # on every host, with the same code + args:
    MARIA_TPU_MULTIHOST=1 python my_sim.py

    # inside the script:
    from maria_tpu.parallel.multihost import initialize_multihost, create_multihost_mesh
    initialize_multihost(coordinator_address="host0:1234",
                         num_processes=n_hosts, process_id=this_host)
    mesh = create_multihost_mesh()    # ("dcn", "det", "time")

Nothing discovers the cluster: pass coordinator_address, num_processes
and process_id explicitly.
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("maria_tpu")

__all__ = [
    "initialize_multihost",
    "is_multihost",
    "create_multihost_mesh",
    "host_local_shard",
    "process_detector_range",
]

_INITIALIZED = False


def multihost_enabled() -> bool:
    """Multi-process bring-up is opt-in: MARIA_TPU_MULTIHOST=1 (so
    single-host users — and the test suite — never pay a coordinator
    handshake or risk a hang waiting for peers)."""
    return os.environ.get("MARIA_TPU_MULTIHOST", "").lower() in ("1", "true", "on")


def initialize_multihost(
    coordinator_address: str = None,
    num_processes: int = None,
    process_id: int = None,
    **kwargs,
) -> bool:
    """Bring up `jax.distributed` when multi-host mode is enabled.

    Returns True iff running multi-process after the call. Idempotent;
    a plain single-process run (flag unset, no explicit args) is a
    no-op so every caller can invoke it unconditionally."""
    global _INITIALIZED
    explicit = coordinator_address is not None or num_processes is not None
    if not (multihost_enabled() or explicit):
        return jax.process_count() > 1
    if _INITIALIZED:
        return jax.process_count() > 1
    if (num_processes or 1) > 1 and jax.config.jax_platforms == "cpu":
        # the CPU backend's default collectives implementation cannot
        # cross processes; gloo can (and is what a CPU-pod integration
        # run uses). Must be set before the backend client is created.
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _INITIALIZED = True
    logger.info(
        "multihost: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return jax.process_count() > 1


def is_multihost() -> bool:
    return jax.process_count() > 1


def _num_slices(devices) -> int:
    """Count ICI domains: devices whose `slice_index` differs can only
    reach each other over DCN. Single-slice (or CPU) backends report 1."""
    indices = {getattr(d, "slice_index", 0) for d in devices}
    return max(len(indices), 1)


def create_multihost_mesh(
    axis_names=("dcn", "det", "time"),
    dcn_size: int = None,
    det_time_shape: tuple = None,
    devices=None,
) -> Mesh:
    """A ("dcn", "det", "time") mesh with the DCN-crossing axis OUTER.

    `dcn_size` defaults to the number of slices (1 on a single slice or
    CPU, so the mesh degenerates to the single-host (det, time) layout
    with a size-1 leading axis — same program, same shardings). Within
    each slice the remaining devices form the (det, time) grid via
    `mesh_shape_for`, so ICI neighbors stay ICI neighbors.

    Uses `mesh_utils.create_hybrid_device_mesh` when there genuinely
    are multiple slices (it orders devices so the outer axis crosses
    DCN and inner axes stay within a slice); otherwise a plain reshape
    of the device list is already correct."""
    from . import mesh_shape_for

    if devices is None:
        devices = jax.devices()
    n = len(devices)
    n_slices = _num_slices(devices)
    dcn = dcn_size or n_slices
    if n % dcn:
        raise ValueError(f"{n} devices do not divide into {dcn} DCN groups.")
    per = n // dcn
    shape = det_time_shape or mesh_shape_for(per)
    if int(np.prod(shape)) != per:
        raise ValueError(f"det/time shape {shape} != {per} devices per DCN group.")

    if dcn > 1 and n_slices == dcn:
        from jax.experimental import mesh_utils

        dev_array = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(1, *shape), dcn_mesh_shape=(dcn,) + (1,) * len(shape),
            devices=devices,
        )
        return Mesh(dev_array, axis_names)
    return Mesh(np.asarray(devices).reshape(dcn, *shape), axis_names)


def process_detector_range(n_det: int, mesh: Mesh, axis: str = "det") -> tuple:
    """[start, stop) of the detector rows this PROCESS can address on
    `mesh` — the contract for per-host data loading: a host builds
    pointing/offsets/tables only for its own rows.

    Detector rows map to mesh-axis blocks in order, so the union over a
    process's addressable devices is a contiguous range (jax device
    order within a process is contiguous along the mesh axes)."""
    axis_idx = mesh.axis_names.index(axis)
    size = mesh.devices.shape[axis_idx]
    block = -(-n_det // size)
    local_ids = {d.id for d in jax.local_devices()}
    rows = [
        idx[axis_idx]
        for idx, dev in np.ndenumerate(mesh.devices)
        if dev.id in local_ids
    ]
    if not rows:
        return (0, 0)
    return (min(rows) * block, min(max(rows) * block + block, n_det))


def host_local_shard(mesh: Mesh, spec: P, global_shape: tuple, fill) -> jax.Array:
    """Assemble a global sharded array from HOST-LOCAL pieces.

    `fill(index_tuple) -> np.ndarray` produces one device shard given
    its global index slices; it is called only for this process's
    addressable shards, so no host ever materializes the global array —
    the per-host data-loading service of SURVEY §5 in one primitive.
    (Single-process this is just a tiled device_put; the call is
    identical on a pod.)"""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        tuple(global_shape), sharding, lambda idx: np.asarray(fill(idx))
    )
