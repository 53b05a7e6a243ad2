"""Multi-chip scaling (no analogue in the reference — see SURVEY.md §2
"Parallelism & communication": the reference is a single-process CPU
package; this subsystem is the device build's divergence).

The simulation's natural mesh is (det, time): detectors are
embarrassingly parallel through atmosphere sampling, bandpass
integration and noise synthesis; the time axis is the sequence-like
axis (screens are shared, samples independent). Map binning reduces
over both axes — a segment-sum followed by a psum across shards, which
XLA inserts automatically from sharding annotations under jit.

PRNG discipline: every random draw threads an explicit key; per-detector
streams derive via fold_in(key, det_index) so results are invariant to
the sharding layout.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("maria_tpu")

__all__ = ["create_mesh", "shard_array", "replicate", "P", "Mesh", "mesh_shape_for"]


def mesh_shape_for(n_devices: int) -> tuple:
    """Pick a 2D (det, time) mesh shape for n devices: as square as
    possible, det-major (detectors usually outnumber useful time shards)."""
    d = int(np.floor(np.sqrt(n_devices)))
    while n_devices % d:
        d -= 1
    return (n_devices // d, d)


def create_mesh(
    n_devices: int = None, axis_names=("det", "time"), shape: tuple = None, devices=None
) -> Mesh:
    """Build a (det, time) mesh from `devices` (default: the default
    platform's devices). Asking for more devices than there are is an
    error; the mesh never borrows devices of another platform."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    n_devices = n_devices or len(devices)
    if n_devices > len(devices):
        raise ValueError(f"Requested {n_devices} devices but only {len(devices)} available.")
    shape = shape or mesh_shape_for(n_devices)
    return Mesh(devices[:n_devices].reshape(shape), axis_names)


def shard_array(mesh: Mesh, x, spec: P):
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))
