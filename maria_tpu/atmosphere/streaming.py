"""Streaming turbulence for arbitrarily long observations.

The reference's AR extrusion "simulates arbitrarily long periods of
atmospheric evolution" at O(n) cost and O(1) memory
(maria/atmosphere/process.py:191-209, README.rst:34-36). This module is
the device counterpart, two ways:

- `StreamingExtrusion`: extrude the screen in fixed-size chunks,
  carrying the standing buffer between chunks. The chunked stream is
  BITWISE identical to one long extrusion given the same innovation
  sequence (tested), so memory stays O(chunk) for any duration.
- `extrude_time_sharded`: the same stream laid out over a device mesh's
  time axis as a pipeline: each shard extrudes its chunk after
  receiving the upstream shard's standing buffer via `lax.ppermute` —
  the halo-exchange pattern a multi-chip deployment uses to time-shard
  a long TOD (SURVEY §5 "long-context"). One observation fills the
  pipeline sequentially; production streams pipeline many chunks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .process import _ar_extrude_noise

__all__ = ["StreamingExtrusion", "extrude_time_sharded"]


class StreamingExtrusion:
    """Chunked AR extrusion with a carried standing buffer."""

    def __init__(self, process, chunk_rows: int):
        process.run_setup()
        self.process = process
        self.chunk_rows = int(chunk_rows)

    def initial_state(self, key):
        """The standing buffer: the `n_extrusion` rows every new row may
        condition on (the decimated lookback window). Burned in by
        extruding 2 n_extrusion rows from a white buffer and keeping the
        newest window, exactly like the one-shot extrusion
        (process.run washes out its transient the same way)."""
        p = self.process
        key_white, key_burn = jax.random.split(key)
        n_burn = 2 * p.n_extrusion
        buffer = jax.random.normal(
            key_white, (n_burn + p.n_extrusion, p.n_cross_section), dtype=jnp.float32
        )
        noise = jax.random.normal(key_burn, (n_burn, p.n_live_edge), dtype=jnp.float32)
        buffer = _ar_extrude_noise(p.A, p.B, buffer, p._ext_idx, p._cross_idx, noise)
        return buffer[: p.n_extrusion]

    def step(self, state, noise):
        """Extrude `chunk_rows` new rows from the carried buffer.

        Returns (new_state, chunk): chunk rows are in STREAM order
        (oldest first), so consecutive chunks concatenate into one
        continuous screen. Internally the extrusion buffer is
        newest-first; the chunk is reversed on the way out."""
        p = self.process
        full = jnp.concatenate(
            [jnp.zeros((self.chunk_rows, p.n_cross_section), dtype=state.dtype), state], axis=0
        )
        full = _ar_extrude_noise(p.A, p.B, full, p._ext_idx, p._cross_idx, noise)
        return full[: p.n_extrusion], full[: self.chunk_rows][::-1]

    def run_chunks(self, key, n_chunks: int):
        """Generate `n_chunks` consecutive screen chunks in stream order
        (each chunk oldest-row-first, so the concatenation is one
        continuous screen), at O(chunk) memory."""
        key_init, key_noise = jax.random.split(key)
        state = self.initial_state(key_init)
        chunks = []
        for c in range(n_chunks):
            noise = jax.random.normal(
                jax.random.fold_in(key_noise, c),
                (self.chunk_rows, self.process.n_live_edge),
                dtype=jnp.float32,
            )
            state, chunk = self.step(state, noise)
            chunks.append(chunk)
        return chunks


def extrude_time_sharded(process, key, chunk_rows: int, mesh, axis_name: str = "time"):
    """Time-sharded streaming extrusion over a device mesh.

    Each shard along `axis_name` produces one chunk of the stream; the
    standing buffer flows shard-to-shard through `lax.ppermute` (the
    halo exchange). The result is bitwise identical to the sequential
    `StreamingExtrusion` stream with the same keys.

    Returns an array of shape (n_shards * chunk_rows, n_cross), sharded
    along the first axis, in stream order (the concatenation of the
    sequential chunks).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    process.run_setup()
    n_shards = dict(zip(mesh.axis_names, mesh.devices.shape))[axis_name]
    stream = StreamingExtrusion(process, chunk_rows)

    key_init, key_noise = jax.random.split(key)
    init_state = stream.initial_state(key_init)
    # per-shard innovations, identical to the sequential stream's chunks
    noise = jnp.stack(
        [
            jax.random.normal(
                jax.random.fold_in(key_noise, c), (chunk_rows, process.n_live_edge), dtype=jnp.float32
            )
            for c in range(n_shards)
        ]
    )  # (n_shards, chunk_rows, n_edge)

    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def shard_fn(state, my_noise):
        # state: (1, n_ext, n_cross) — every shard starts with the initial
        # standing buffer; only shard 0's copy is meaningful at step 0.
        # my_noise: (1, chunk_rows, n_edge)
        state = state[0]

        def body(c, carry):
            state, out = carry
            new_state, chunk = stream.step(state, my_noise[0])
            mine = jax.lax.axis_index(axis_name) == c
            out = jnp.where(mine, chunk, out)
            kept = jnp.where(mine, new_state, state)
            # hand the updated buffer to the downstream neighbor
            passed = jax.lax.ppermute(kept, axis_name, perm)
            state = jnp.where(jax.lax.axis_index(axis_name) == c + 1, passed, state)
            return state, out

        out0 = jnp.zeros((chunk_rows, process.n_cross_section), dtype=jnp.float32)
        # the out carry becomes device-varying inside the loop (it
        # depends on axis_index); mark the initial value accordingly
        out0 = jax.lax.pcast(out0, (axis_name,), to="varying")
        _, out = jax.lax.fori_loop(0, n_shards, body, (state, out0))
        return out[None]

    spec_state = P(axis_name, None, None)
    states = jnp.broadcast_to(init_state, (n_shards, *init_state.shape))
    with mesh:
        fn = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(spec_state, P(axis_name, None, None)),
            out_specs=P(axis_name, None, None),
        )
        out = fn(
            jax.device_put(states, NamedSharding(mesh, spec_state)),
            jax.device_put(noise, NamedSharding(mesh, P(axis_name, None, None))),
        )
    return out.reshape(n_shards * chunk_rows, process.n_cross_section)
