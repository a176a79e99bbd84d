"""The shard_map tick (parallel/shard_tick.py) is bit-equivalent to the
single-device tick on every state field, for all three compute paths
(dense connectivity, grid connectivity, Pallas interpret), on an 8-device
CPU mesh.

This is the framework's multi-device correctness contract: the explicit
collectives in parallel/comm.py (all_gather / psum / psum_scatter) carry
exactly the cross-robot data the local tick reads through plain indexing,
and the PRNG draws are global-axis draws so comms failure patterns do not
depend on the sharding (SURVEY.md §7 hard part (e))."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from magics_tpu.graph import tick as T
from magics_tpu.parallel import shard_tick as ST
from magics_tpu.sim.builder import build_scenario, circle_formation


def _assert_equivalent(params, state, sdf, env_dist=None, n=5):
    step = jax.jit(T.step, static_argnums=2)
    s_ref = state
    for _ in range(n):
        s_ref = step(s_ref, sdf, params, env_dist)

    mesh = Mesh(np.array(jax.devices()), ("r",))
    s_sh = ST.shard_state(state, mesh)
    repl = lambda x: jax.device_put(x, NamedSharding(mesh, P()))
    fn = ST.make_shard_step(
        mesh, params, state.n_robots, n_ticks=n,
        with_env_dist=env_dist is not None,
    )
    args = (s_sh, repl(sdf)) + ((repl(env_dist),) if env_dist is not None else ())
    s_out = fn(*args)

    bad = []
    for f in dataclasses.fields(type(state)):
        a = np.asarray(getattr(s_ref, f.name))
        b = np.asarray(getattr(s_out, f.name))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            ok = np.array_equal(a, b)
        else:
            ok = np.allclose(a, b, rtol=1e-12, atol=1e-12, equal_nan=True)
        if not ok:
            bad.append(f.name)
    assert not bad, f"sharded tick diverged from local tick on: {bad}"


def test_dense_tick_shard_equivalence():
    specs = circle_formation(16, circle_radius=20.0, target_speed=8.0)
    params, state, sdf = build_scenario(
        specs, target_speed=8.0, planning_horizon=1.0, comms_radius=60.0,
        internal=3, external=2, n_slots=4, dtype=jnp.float64,
        comms_failure_rate=0.2, seed=3,
    )
    _assert_equivalent(params, state, sdf)


@pytest.mark.slow
def test_grid_tick_shard_equivalence_with_env():
    specs = circle_formation(16, circle_radius=20.0, target_speed=8.0)
    params, state, sdf = build_scenario(
        specs, target_speed=8.0, planning_horizon=1.0, comms_radius=30.0,
        internal=3, external=2, n_slots=4, dtype=jnp.float64,
        comms_failure_rate=0.2, seed=7, grid_cell_size=15.0, grid_capacity=8,
        collision_partners=4, world=(120.0, 120.0),
    )
    env_dist = np.full((16, 16), 100.0)
    env_dist[:4, :4] = 0.0  # obstacle corner so env collisions fire
    _assert_equivalent(params, state, sdf, env_dist=jnp.asarray(env_dist))


@pytest.mark.slow
def test_pallas_tick_shard_equivalence():
    specs = circle_formation(16, circle_radius=20.0, target_speed=8.0)
    params, state, sdf = build_scenario(
        specs, target_speed=8.0, planning_horizon=1.0, comms_radius=60.0,
        internal=3, external=2, n_slots=4, dtype=jnp.float64,
        comms_failure_rate=0.1, seed=5,
        use_pallas=True, pallas_interpret=True,
    )
    _assert_equivalent(params, state, sdf)


def test_shard_equivalence_with_logs_and_goal_areas():
    """Exercises the axis-1-sharded fields (pos/vel/viz ring buffers,
    goal-area history) that the basic tests leave empty."""
    specs = circle_formation(16, circle_radius=20.0, target_speed=8.0)
    params, state, sdf = build_scenario(
        specs, target_speed=8.0, planning_horizon=1.0, comms_radius=60.0,
        internal=3, external=2, n_slots=4, dtype=jnp.float64,
        comms_failure_rate=0.1, seed=9,
        log_every=2, log_capacity=8, viz_log_capacity=4,
        goal_areas=np.array([[-30.0, -30.0, 30.0, 30.0]]),
    )
    _assert_equivalent(params, state, sdf)


def test_shard_step_rejects_bad_capacity():
    specs = circle_formation(10, circle_radius=20.0, target_speed=8.0)
    params, state, sdf = build_scenario(
        specs, target_speed=8.0, internal=1, external=1, n_slots=4,
        dtype=jnp.float64,
    )
    mesh = Mesh(np.array(jax.devices()), ("r",))
    with pytest.raises(ValueError, match="capacity"):
        ST.make_shard_step(mesh, params, 10)
