"""The distributed communication backend, as an explicit component.

The reference routes inter-robot GBP messages in-process by looking up the
destination factor graph by entity id (crates/magics/src/planner/robot.rs:
1803-1858) — its "network" is a Vec of (from, to, message) triples pushed
between ECS components. SURVEY.md §2.4 maps that to a device mesh: robots
sharded over a mesh axis, message exchange lowering to collectives between
devices, with antenna/radius gates as boolean masks.

This module makes that backend explicit and swappable. Every cross-robot
access in the tick (neighbour discovery, inter-robot message delivery,
column-reductions of pairwise event matrices) goes through a `Comm`:

  * `LocalComm`  — one address space: every robot-major array is already
    global, gathers are plain `arr[idx]`, reductions are no-ops. This is
    both the single-chip path and the GSPMD path (under plain `jit` over
    sharded inputs, XLA partitions these same gathers automatically).
  * `ShardComm`  — inside `jax.shard_map` over a robot-sharded mesh axis:
    each shard holds `R/p` robots; `all_robots` is `lax.all_gather`
    (tiled) over the axis, scalar event counts `lax.psum`, and per-robot
    column-sums of pairwise matrices `lax.psum_scatter`. XLA hands these to
    NCCL on GPUs; neighbour indices stay *global* robot ids, so
    shard-local code is identical to the local path.

Both are frozen dataclasses (hashable) so they can be closed over by jit as
static configuration, exactly like `GbpParams`.

Why all-gather and not a spatial halo exchange: robots are sharded by id,
not by position (they move; any spatial partition churns), so a shard's
neighbours can live anywhere — the exchange is inherently all-to-all. The
gathered tensors are small (positions [R, 2]; compact rank-1 message tables
[R, K, V-1, 4] — ~2.6 MB at R=1024, K=8, V=21 f32), small next to the
link bandwidth between devices at the tick rates involved. `reduce_scatter`/`psum` carry the
event-count reductions back. A spatially sorted robot order (so most
neighbours are shard-local and the gather's useful fraction is high) is a
layout optimisation on top, not a different backend.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass(frozen=True)
class LocalComm:
    """Single address space: arrays are already global."""

    def all_robots(self, arr: jax.Array) -> jax.Array:
        """Global view of a robot-major (leading axis = robots) array."""
        return arr

    def row_ids(self, n_local: int) -> jax.Array:
        """Global robot ids of the local rows."""
        return jnp.arange(n_local, dtype=jnp.int32)

    def row_offset(self) -> jax.Array:
        return jnp.asarray(0, dtype=jnp.int32)

    def psum(self, x: jax.Array) -> jax.Array:
        """Sum a (replicated-output) value over shards."""
        return x

    def scatter_rows(self, arr: jax.Array) -> jax.Array:
        """Reduce a [R_total, ...] per-global-robot partial sum across shards
        and keep the local rows (reduce-scatter). Local: identity."""
        return arr

    def take_rows(self, arr: jax.Array, n_local: int) -> jax.Array:
        """Slice the local rows out of a [R_total, ...] array."""
        return arr


@dataclasses.dataclass(frozen=True)
class ShardComm:
    """Inside `jax.shard_map` over a 1-D robot mesh axis.

    `n_shards * n_local == R_total`; robot r lives on shard r // n_local at
    local row r % n_local (tiled all_gather order).
    """

    axis: str
    n_shards: int
    n_local: int  # robots per shard (uniform)

    def all_robots(self, arr: jax.Array) -> jax.Array:
        return lax.all_gather(arr, self.axis, tiled=True)

    def row_ids(self, n_local: int) -> jax.Array:
        return self.row_offset() + jnp.arange(n_local, dtype=jnp.int32)

    def row_offset(self) -> jax.Array:
        return (lax.axis_index(self.axis) * self.n_local).astype(jnp.int32)

    def psum(self, x: jax.Array) -> jax.Array:
        return lax.psum(x, self.axis)

    def scatter_rows(self, arr: jax.Array) -> jax.Array:
        return lax.psum_scatter(arr, self.axis, tiled=True)

    def take_rows(self, arr: jax.Array, n_local: int) -> jax.Array:
        return lax.dynamic_slice_in_dim(arr, self.row_offset(), n_local, axis=0)


LOCAL = LocalComm()
