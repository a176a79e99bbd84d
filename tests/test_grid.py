"""Spatial-grid neighbour search (graph/grid.py) vs the dense O(R^2) path.

The grid is a pure acceleration structure: given sufficient bucket capacity
it must reproduce the dense path's neighbour sets, inter-robot factor tables,
and collision counts exactly (the exact distance test still runs on the
candidates). Reference semantics: robot.rs:1362-1586, collisions.rs:102-140.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from magics_tpu.graph import grid as G
from magics_tpu.graph import tick as T
from magics_tpu.sim.builder import build_scenario, circle_formation


def brute_force_pairs(pos, active, radius):
    R = len(pos)
    out = set()
    for i in range(R):
        for j in range(R):
            if i == j or not (active[i] and active[j]):
                continue
            if np.sum((pos[i] - pos[j]) ** 2) <= radius * radius:
                out.add((i, j))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_candidates_cover_all_in_range_pairs(seed):
    rng = np.random.default_rng(seed)
    R = 64
    world = (100.0, 100.0)
    pos = rng.uniform(-48, 48, size=(R, 2))
    active = rng.random(R) > 0.2
    radius = 17.0

    spec = G.make_grid_spec(world, cell_size=8.0, search_radius=radius, capacity=16)
    cell, bucket = G.build_grid(spec, jnp.asarray(pos), jnp.asarray(active))
    cand, mask = G.candidate_neighbours(spec, cell, bucket, jnp.asarray(active))
    assert int(G.grid_overflow(spec, jnp.asarray(pos), jnp.asarray(active))) == 0

    cand = np.asarray(cand)
    mask = np.asarray(mask)
    got = set()
    for i in range(R):
        for m in range(cand.shape[1]):
            if mask[i, m]:
                j = cand[i, m]
                if np.sum((pos[i] - pos[j]) ** 2) <= radius * radius:
                    got.add((i, int(j)))
    assert got == brute_force_pairs(pos, active, radius)


def test_no_duplicate_candidates():
    rng = np.random.default_rng(7)
    R = 40
    pos = rng.uniform(-45, 45, size=(R, 2))
    active = np.ones(R, dtype=bool)
    spec = G.make_grid_spec((100.0, 100.0), 10.0, 25.0, capacity=64)
    cell, bucket = G.build_grid(spec, jnp.asarray(pos), jnp.asarray(active))
    cand, mask = G.candidate_neighbours(spec, cell, bucket, jnp.asarray(active))
    cand, mask = np.asarray(cand), np.asarray(mask)
    for i in range(R):
        ids = cand[i][mask[i]]
        assert len(ids) == len(set(ids.tolist()))


def _build(R, grid: bool):
    specs = circle_formation(R, circle_radius=20.0, target_speed=8.0)
    over = (
        # collision_partners >= R-1 makes the partner-table hysteresis exact
        # (the circle-center crush overlaps nearly everyone simultaneously)
        dict(grid_cell_size=15.0, grid_capacity=64, collision_partners=23)
        if grid
        else {}
    )
    return build_scenario(
        specs,
        target_speed=8.0,
        planning_horizon=2.0,
        hz=10.0,
        comms_radius=30.0,
        internal=4,
        external=2,
        n_slots=8,
        dtype=jnp.float64,
        **over,
    )


@pytest.mark.slow
def test_grid_tick_matches_dense_exactly():
    """Full-tick lockstep: with ample bucket capacity the grid path must be
    bit-identical to the dense path in every shared state field."""
    R = 24
    pd, sd, sdf = _build(R, grid=False)
    pg, sg, _ = _build(R, grid=True)

    for _ in range(25):
        sd = T.step(sd, sdf, pd)
        sg = T.step(sg, sdf, pg)

    skip = {"rr_overlap", "rr_partner"}  # mode-specific hysteresis storage
    for fld in dataclasses.fields(sd):
        if fld.name in skip:
            continue
        a = np.asarray(getattr(sd, fld.name))
        b = np.asarray(getattr(sg, fld.name))
        np.testing.assert_array_equal(a, b, err_msg=f"field {fld.name} diverged")

    # collision hysteresis state agrees semantically
    dense_partners = np.asarray(sd.rr_overlap)
    grid_partners = np.asarray(sg.rr_partner)
    for i in range(R):
        dense_set = set(np.nonzero(dense_partners[i])[0].tolist())
        # dense matrix is upper-triangular; symmetrise
        dense_set |= set(np.nonzero(dense_partners[:, i])[0].tolist())
        grid_set = set(int(j) for j in grid_partners[i] if j >= 0)
        assert dense_set == grid_set, f"robot {i} overlap partners diverged"


def _two_robot_specs(d):
    """Two stationary-ish robots `d` apart (radius 2.0 each)."""
    from magics_tpu.sim.builder import RobotSpec

    specs = []
    for x in (0.0, d):
        start = np.array([x, 0.0, 0.0, 0.0])
        # goal far enough that the mission is not completed instantly
        goal = np.array([x, 20.0, 0.0, 0.0])
        specs.append(
            RobotSpec(start=start, waypoints=np.stack([start, goal]), radius=2.0)
        )
    return specs


@pytest.mark.slow
def test_grid_collision_radius_independent_of_comms():
    """Colliding pairs outside the comms radius must still be counted: the
    collision grid's stencil derives from 2*max_robot_radius, not from
    params.comms_radius (ADVICE r1, tick.py:update_collisions_grid)."""
    # robots at distance 3.0 overlap (radius sum 4.0) but are far outside the
    # 1.0 comms radius; with cell 1.0 a comms-radius stencil (reach 1) would
    # never see the pair.
    specs = _two_robot_specs(3.0)
    params, state, sdf = build_scenario(
        specs,
        target_speed=1.0,
        planning_horizon=2.0,
        comms_radius=1.0,
        internal=1,
        external=0,
        n_slots=2,
        dtype=jnp.float64,
        grid_cell_size=1.0,
        grid_capacity=8,
        collision_partners=4,
    )
    assert params.max_robot_radius == 2.0
    state = T.step(state, sdf, params)
    assert int(state.rr_collisions) == 1
    assert int(state.rr_partner_overflow) == 0


@pytest.mark.slow
def test_partner_table_overflow_counter():
    """More simultaneous overlaps than collision_partners slots must be
    visible via rr_partner_overflow (ADVICE r1, state.py collision_partners)."""
    from magics_tpu.sim.builder import RobotSpec

    R = 6
    specs = []
    for i in range(R):
        start = np.array([0.05 * i, 0.0, 0.0, 0.0])
        goal = np.array([0.05 * i, 20.0, 0.0, 0.0])
        specs.append(
            RobotSpec(start=start, waypoints=np.stack([start, goal]), radius=2.0)
        )
    params, state, sdf = build_scenario(
        specs,
        target_speed=1.0,
        planning_horizon=2.0,
        comms_radius=1.0,
        internal=1,
        external=0,
        n_slots=8,
        dtype=jnp.float64,
        grid_cell_size=1.0,
        grid_capacity=16,
        collision_partners=2,  # 5 simultaneous overlaps per robot
    )
    state = T.step(state, sdf, params)
    # each robot overlaps 5 others but records only 2: 3 dropped each
    assert int(state.rr_partner_overflow) == R * 3


def test_grid_overflow_counter_in_state():
    """Undersized `grid_capacity` must be visible in-state: the circle-center
    crush packs ~all robots into one cell, so capacity 2 drops robots from
    the bucket and `state.grid_overflow` must go nonzero (round-4 verdict:
    drops were 'counted nowhere' during runs). With ample capacity the
    counter stays zero."""
    import jax

    R = 16
    specs = circle_formation(R, circle_radius=6.0, target_speed=8.0)
    kw = dict(
        target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=30.0,
        internal=2, external=1, n_slots=8, dtype=jnp.float64,
    )
    p_small, s_small, sdf = build_scenario(
        specs, grid_cell_size=15.0, grid_capacity=2, collision_partners=15, **kw
    )
    p_big, s_big, _ = build_scenario(
        specs, grid_cell_size=15.0, grid_capacity=32, collision_partners=15, **kw
    )
    step = jax.jit(T.step, static_argnums=2)
    for _ in range(3):
        s_small = step(s_small, sdf, p_small)
        s_big = step(s_big, sdf, p_big)
    assert int(np.asarray(s_small.grid_overflow)) > 0
    assert int(np.asarray(s_big.grid_overflow)) == 0
