"""Explicit-collective tick: `shard_map` over a robot-sharded mesh.

Two ways to scale the swarm over devices exist in this framework:

  1. **GSPMD (parallel/sharding.py)** — place the state with NamedSharding
     and jit the ordinary `tick.step`; XLA partitions the cross-robot
     gathers automatically. Zero code, good default.
  2. **shard_map (this module)** — run the same tick body per shard with
     every cross-robot exchange an explicit collective from
     `parallel/comm.ShardComm`: `all_gather` for neighbour positions /
     slot tables / compact rank-1 message outboxes, `psum` for global
     event counts, `psum_scatter` for per-robot column reductions. This
     is the scaling-book recipe with the communication *visible*: what
     moves between devices per tick is exactly the small tensors listed in
     comm.py, independent of what GSPMD would infer.

Both paths compute bit-identical results to the single-device tick (the
tick's maths never branches on the sharding; tests/test_shard_tick.py
asserts it on an 8-device CPU mesh).

Partition layout (axis "r" = robots):
  [R, ...] state arrays        -> P("r", ...)
  ring-buffer logs [L, R, ...] -> P(None, "r", ...)
  goal areas [G, R]            -> P(None, "r")
  pairwise hysteresis [R, R]   -> P("r", None)   (rows local, columns global)
  scalars / PRNG key / AABBs   -> P()            (replicated)

Constraints: R % n_devices == 0 (pad capacity in the builder), and
collision event AABB ring buffers off (collision_log_capacity=0) — their
write order is global (see tick.update_collisions).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from magics_tpu.graph import tick as T
from magics_tpu.graph.state import GbpParams, SimState
from magics_tpu.parallel.comm import ShardComm

# state fields whose ROBOT axis is axis 1 (ring buffers, goal-area history)
_ROBOT_AXIS1 = {"pos_log", "vel_log", "viz_mean", "viz_cov", "viz_trk", "ga_history"}
# replicated fields: scalars, the PRNG key, goal-area AABBs, event buffers
_REPLICATED = {
    "tick", "rng", "log_head",
    "rr_collisions", "re_collisions",
    "rr_event_count", "re_event_count", "rr_partner_overflow", "nbr_overflow",
    "grid_overflow",
    "rr_events", "re_events", "ga_aabb",
}


def state_partition_specs() -> SimState:
    """A SimState-shaped pytree of PartitionSpecs for mesh axis "r"."""
    specs = {}
    for f in dataclasses.fields(SimState):
        if f.name in _REPLICATED:
            specs[f.name] = P()
        elif f.name in _ROBOT_AXIS1:
            specs[f.name] = P(None, "r")
        else:
            specs[f.name] = P("r")
    return SimState(**specs)


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place the state on the mesh according to state_partition_specs."""
    specs = state_partition_specs()
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state,
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def make_shard_step(
    mesh: Mesh,
    params: GbpParams,
    n_robots: int,
    *,
    n_ticks: int = 1,
    with_env_dist: bool = False,
):
    """Jitted `run_ticks` under shard_map with explicit collectives.

    Returns fn(state, sdf[, env_dist]) -> state. Inputs must be placed with
    `shard_state` / replicated (`jax.device_put(x, NamedSharding(mesh, P()))`).
    """
    axis = mesh.axis_names[0]
    n_shards = int(mesh.devices.size)
    if n_robots % n_shards:
        raise ValueError(
            f"robot capacity {n_robots} must divide the {n_shards}-device mesh "
            "(pad `capacity` in the builder)"
        )
    if params.collision_log_capacity > 0:
        raise ValueError(
            "collision_log_capacity must be 0 for the shard_map tick "
            "(event ring-buffer write order is global)"
        )
    comm = ShardComm(axis=axis, n_shards=n_shards, n_local=n_robots // n_shards)
    specs = state_partition_specs()

    if with_env_dist:
        def local_fn(state, sdf, env_dist):
            return T.run_ticks(state, sdf, params, n_ticks, env_dist, comm)

        in_specs = (specs, P(), P())
    else:
        def local_fn(state, sdf):
            return T.run_ticks(state, sdf, params, n_ticks, None, comm)

        in_specs = (specs, P())

    fn = jax.shard_map(
        local_fn, mesh=mesh, in_specs=in_specs, out_specs=specs, check_vma=False
    )
    return jax.jit(fn)
