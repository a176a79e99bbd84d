"""Every reference scenario builds into a full Simulator (SDF bake,
formation placement, mission pre-planning), and representative ones run
ticks end-to-end — the integration layer the reference never had
(SURVEY.md §4: its experiment scripts are the de-facto integration tests).

Scenario configs are read straight from the reference's own
config/scenarios/ tree (they parse unchanged, config/loader.py)."""

from __future__ import annotations

import numpy as np
import pytest

from magics_tpu.config.loader import list_scenarios, load_scenario
from magics_tpu.sim.simulator import Simulator

REF_SCENARIOS = "/root/reference/config/scenarios"

ALL = list_scenarios(REF_SCENARIOS)

# scenarios whose build alone costs 20-35 s (global-planner pre-planning /
# big SDF bakes) live in the slow tier; the fast tier keeps broad coverage
# with the cheap ones (a core tier under ~5 min)
_HEAVY = {
    "Collaborative GP", "Collaborative Complex", "Solo GP", "Showcase",
    "Communications Failure Experiment", "Varying Network Connectivity "
    "Experiment", "Environment Obstacles Experiment",
}


@pytest.mark.parametrize(
    "name",
    [pytest.param(n, marks=pytest.mark.slow) if n in _HEAVY else n
     for n in ALL],
)
def test_scenario_builds_simulator(name):
    s = load_scenario(f"{REF_SCENARIOS}/{name}")
    # cap the pre-planned horizon so infinite-repeat spawners stay small
    sim = Simulator(s, max_sim_time=8.0, n_slots=4)
    assert sim.state.n_robots >= 1
    assert sim.params.n_vars >= 3
    # SDF and distance field rasterized to the configured resolution
    assert sim.env_dist_np.ndim == 2 and np.isfinite(sim.env_dist_np).all()
    # at least one robot has a mission with >= 2 waypoint states (display-only
    # scenarios like Obstacle Shapes Showcase spawn a single inert slot)
    if any(sp.spawn_tick >= 0 for sp in sim.specs):
        assert int(np.max(np.asarray(sim.state.n_waypoints))) >= 2


@pytest.mark.parametrize(
    "name",
    [
        "Junction Experiment",            # crossing streams, goal areas
        pytest.param("Communications Failure Experiment",
                     marks=pytest.mark.slow),  # failure_rate > 0, big SDF
        pytest.param("Structured Junction",
                     marks=pytest.mark.slow),  # tile grid + obstacles
    ],
)
def test_scenario_runs_ticks(name):
    s = load_scenario(f"{REF_SCENARIOS}/{name}")
    sim = Simulator(s, max_sim_time=5.0, n_slots=4)
    sim.run(max_ticks=8)
    pos = np.asarray(sim.state.pos)
    active = np.asarray(sim.state.active)
    assert np.isfinite(pos[active]).all()
    # someone spawned and the GBP tick moved beliefs
    assert active.any()
    assert np.isfinite(np.asarray(sim.state.belief_mean)[active]).all()
