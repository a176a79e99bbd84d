"""Shard the swarm over a device mesh.

The reference "distributes" robots over Bevy's CPU thread pool within one
process (robot.rs:1789-1800). Here the robot axis of every `[R, ...]` array is
sharded over a 1-D `jax.sharding.Mesh` axis ("r"); the inter-robot message
gathers in the tick (`arr[nbr_idx, back]`) become XLA collectives
(all-to-all / collective-permute between devices) inserted by GSPMD under jit. The
`[R, R]` neighbour-discovery and collision matrices shard by rows so each
device scans all positions (replicated [R,2] gather) against its own robots.

This is the annotate-and-let-XLA-partition design: pick a mesh, place the
state, jit the same `tick.step` — no communication code is duplicated.

The sibling modules make the communication explicit instead:
`parallel/comm.py` (the backend as a component) and `parallel/shard_tick.py`
(the tick under shard_map with hand-placed all_gather/psum/reduce-scatter) —
same maths, bit-identical results, with the per-tick device-to-device traffic visible
and independent of GSPMD's partitioning choices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from magics_tpu.graph.state import SimState


def make_robot_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devices), ("r",))


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place every robot-major array with its leading axis on mesh axis "r";
    ring buffers / goal-area history ([L, R, ...]) shard their axis-1 robot
    dimension; scalars and the PRNG key replicate. Same layout as
    shard_tick.state_partition_specs, so the two paths place identically.

    Placement is driven by field NAME (the shard_tick specs), not by shape
    matching — a shape heuristic misclassifies arrays whose non-robot dim
    coincidentally equals R (e.g. ga_aabb [G, 4] at R=4)."""
    from magics_tpu.parallel import shard_tick

    specs = shard_tick.state_partition_specs()
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state,
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))
