"""Spatial-grid neighbour search — O(R) replacement for the O(R^2) scans.

The reference discovers neighbours with an all-pairs distance check every
FixedUpdate (crates/magics/src/planner/robot.rs:1362-1384) and counts
robot-robot collisions the same way (planner/collisions.rs:102-140). That is
fine for its 5-50 robot experiments but materialises [R, R] matrices — at the
swarm scales this framework targets (10k+ robots) those are gigabytes per
tick and quadratic FLOPs.

This module bins robots into a uniform grid of cells and restricts the pair
search to a static stencil of nearby cells, keeping every shape static for
XLA:

  * `build_grid`   — cell id per robot, then a [n_cells, C] bucket table of
    robot ids built with one argsort + scatter (C = fixed cell capacity).
  * `candidate_neighbours` — for each robot, gather the buckets of the
    (2*reach+1)^2 surrounding cells into a [R, M] candidate id table
    (M = stencil * C), with a validity mask.

The stencil reach is chosen so any pair within `radius` shares the stencil
(reach = ceil(radius / cell)); the exact distance test still runs on the
candidates, so the grid changes complexity, not semantics. The only
approximation is the fixed cell capacity C: overflowing robots are dropped
from that cell's bucket (counted nowhere). Capacity is a builder knob sized
from expected density; `grid_overflow` reports drops for validation runs.

Shapes: the bucket build is one sort over [R] keys plus gathers — all
static shapes, no host sync. The candidate tables are [R, M] with
M = stencil * capacity (e.g. 25 * 16 = 400), so memory is O(R * M) instead
of O(R^2): at R = 16k that is ~25 MB instead of ~1 GB per f32 matrix.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (hashable, closed over by jit)."""

    cell_size: float
    nx: int                 # cells along x (world width + margin rings)
    ny: int
    reach: int              # stencil half-width in cells
    capacity: int           # max robots recorded per cell
    origin_x: float         # world coordinate of cell (0, 0)'s min corner
    origin_y: float

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @property
    def stencil(self) -> int:
        return (2 * self.reach + 1) ** 2

    @property
    def n_candidates(self) -> int:
        return self.stencil * self.capacity


def make_grid_spec(
    world: tuple[float, float],
    cell_size: float,
    search_radius: float,
    capacity: int,
) -> GridSpec:
    """Build the static spec: margin rings of `reach` cells on every side so
    robots up to reach*cell outside the world still resolve exactly."""
    reach = max(1, int(math.ceil(search_radius / cell_size)))
    nx = int(math.ceil(world[0] / cell_size)) + 2 * reach
    ny = int(math.ceil(world[1] / cell_size)) + 2 * reach
    return GridSpec(
        cell_size=float(cell_size),
        nx=nx,
        ny=ny,
        reach=reach,
        capacity=int(capacity),
        origin_x=-world[0] / 2.0 - reach * cell_size,
        origin_y=-world[1] / 2.0 - reach * cell_size,
    )


def cell_ids(spec: GridSpec, pos: jax.Array, active: jax.Array) -> jax.Array:
    """[R] int32 cell id per robot; inactive robots park in a virtual
    overflow cell `n_cells` so they never appear in any bucket."""
    cx = jnp.floor((pos[:, 0] - spec.origin_x) / spec.cell_size).astype(jnp.int32)
    cy = jnp.floor((pos[:, 1] - spec.origin_y) / spec.cell_size).astype(jnp.int32)
    cx = jnp.clip(cx, 0, spec.nx - 1)
    cy = jnp.clip(cy, 0, spec.ny - 1)
    cid = cy * spec.nx + cx
    return jnp.where(active, cid, spec.n_cells)


def build_grid(
    spec: GridSpec, pos: jax.Array, active: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Returns (cell [R], bucket [n_cells, C] of robot ids, -1 empty).

    One stable argsort groups robots by cell; the rank of a robot within its
    cell is its bucket column. Robots ranked past capacity drop (mode="drop").
    """
    cell = cell_ids(spec, pos, active)
    order, sorted_cell, rank = _bucket_order(cell)
    bucket = jnp.full((spec.n_cells + 1, spec.capacity), -1, dtype=jnp.int32)
    bucket = bucket.at[sorted_cell, rank].set(
        order.astype(jnp.int32), mode="drop"
    )[: spec.n_cells]
    return cell, bucket


def _bucket_order(cell: jax.Array):
    R = cell.shape[0]
    order = jnp.argsort(cell, stable=True)          # robot ids grouped by cell
    sorted_cell = cell[order]
    # first occurrence index of each cell value == searchsorted against itself
    starts = jnp.searchsorted(sorted_cell, sorted_cell, side="left")
    rank = jnp.arange(R, dtype=jnp.int32) - starts.astype(jnp.int32)
    return order, sorted_cell, rank


def build_grid_tables(
    spec: GridSpec, pos: jax.Array, active: jax.Array, radius: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Bucket tables carrying the robots' DATA alongside their ids:
    (bucket [n_cells, C] ids, bucket_pos [n_cells, C, 2],
    bucket_rad [n_cells, C]).

    Why: the stencil lookup `bucket[ncid]` gathers [R, stencil] ROWS — fast.
    But then fetching each candidate's position/radius (`pos[cand]`) is an
    [R, stencil*C] element gather — R*M near-scalar accesses, where a
    gather's cost grows with the number of rows it fetches. Scattering the
    positions into bucket-aligned tables at build time turns those into the
    same cheap [R, stencil] row gathers as the ids. Empty bucket entries
    hold a far-away position (1e30) so distance tests fail naturally.
    """
    f = pos.dtype
    cell = cell_ids(spec, pos, active)
    order, sorted_cell, rank = _bucket_order(cell)
    n1 = spec.n_cells + 1
    C = spec.capacity
    bucket = jnp.full((n1, C), -1, dtype=jnp.int32)
    bucket = bucket.at[sorted_cell, rank].set(order.astype(jnp.int32), mode="drop")
    bpos = jnp.full((n1, C, 2), 1e30, dtype=f)
    bpos = bpos.at[sorted_cell, rank].set(pos[order], mode="drop")
    brad = jnp.zeros((n1, C), dtype=radius.dtype)
    brad = brad.at[sorted_cell, rank].set(radius[order], mode="drop")
    return bucket[: spec.n_cells], bpos[: spec.n_cells], brad[: spec.n_cells]


def grid_overflow(spec: GridSpec, pos: jax.Array, active: jax.Array) -> jax.Array:
    """Number of robots dropped from over-full cells (validation helper)."""
    cell = cell_ids(spec, pos, active)
    counts = jnp.zeros((spec.n_cells + 1,), jnp.int32).at[cell].add(1)[: spec.n_cells]
    return jnp.sum(jnp.maximum(counts - spec.capacity, 0))


def candidate_neighbours(
    spec: GridSpec,
    cell: jax.Array,       # [R] (local rows when sharded)
    bucket: jax.Array,     # [n_cells, C] — GLOBAL bucket table
    active: jax.Array,     # [R] (local rows when sharded)
    row_ids: jax.Array | None = None,  # [R] global ids of the rows; None = arange
) -> tuple[jax.Array, jax.Array]:
    """For each robot, the ids of all robots bucketed in its stencil.

    Returns (cand_idx [R, M] int32 with -1 invalid, cand_mask [R, M]); the
    self pair is masked out. Cells in the stencil that fall off the grid are
    masked rather than clamped, so no candidate appears twice. Bucket entries
    are global robot ids; when the caller shards robots, `cell`/`active` are
    the local rows and `row_ids` their global ids (for self-pair masking).
    """
    ncid, valid_cell = _stencil_cells(spec, cell)
    R = cell.shape[0]
    cand = bucket[ncid]                                 # [R, S, C]
    cand = jnp.where(valid_cell[..., None], cand, -1)
    cand = cand.reshape(R, -1)                          # [R, M]

    me = (jnp.arange(R, dtype=jnp.int32) if row_ids is None else row_ids)[:, None]
    mask = (cand >= 0) & (cand != me) & active[:, None]
    # inactive robots are never bucketed, so cand >= 0 implies active[cand]
    return jnp.where(mask, cand, -1), mask


def _stencil_cells(spec: GridSpec, cell: jax.Array):
    """Stencil cell ids per robot: (ncid [R, S], valid_cell [R, S])."""
    cx = cell % spec.nx
    cy = cell // spec.nx

    offs = [
        (dx, dy)
        for dy in range(-spec.reach, spec.reach + 1)
        for dx in range(-spec.reach, spec.reach + 1)
    ]
    odx = jnp.asarray([o[0] for o in offs], jnp.int32)  # [S]
    ody = jnp.asarray([o[1] for o in offs], jnp.int32)

    ncx = cx[:, None] + odx[None, :]                    # [R, S]
    ncy = cy[:, None] + ody[None, :]
    valid_cell = (ncx >= 0) & (ncx < spec.nx) & (ncy >= 0) & (ncy < spec.ny)
    ncid = jnp.clip(ncy, 0, spec.ny - 1) * spec.nx + jnp.clip(ncx, 0, spec.nx - 1)
    return ncid, valid_cell


def candidate_data(
    spec: GridSpec,
    cell: jax.Array,       # [R] (local rows when sharded)
    bucket: jax.Array,     # [n_cells, C] ids — GLOBAL
    bpos: jax.Array,       # [n_cells, C, 2] positions — GLOBAL
    brad: jax.Array,       # [n_cells, C] radii — GLOBAL
    active: jax.Array,     # [R]
    row_ids: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Candidates WITH their data: (cand_idx [R, M], cand_pos [R, M, 2],
    cand_rad [R, M], cand_mask [R, M]). All three tables gather by the same
    [R, S] stencil rows — no per-candidate element gathers (see
    build_grid_tables). Invalid entries: idx -1, pos 1e30, rad 0."""
    ncid, valid_cell = _stencil_cells(spec, cell)
    R = cell.shape[0]
    cand = jnp.where(valid_cell[..., None], bucket[ncid], -1).reshape(R, -1)
    cpos = bpos[ncid].reshape(R, -1, 2)                 # far-away where empty
    crad = brad[ncid].reshape(R, -1)

    me = (jnp.arange(R, dtype=jnp.int32) if row_ids is None else row_ids)[:, None]
    mask = (cand >= 0) & (cand != me) & active[:, None]
    return jnp.where(mask, cand, -1), cpos, crad, mask
