"""Headline benchmark: GBP message updates/s on one device.

Workload: the gbpplanner Circle-Experiment configuration scaled up — R robots
equally spaced on a circle all crossing to the antipodal point, speed 15 m/s,
5 s horizon (V=21 variables), 50 internal + 10 external GBP iterations per
10 Hz simulation tick (config/scenarios/Circle Experiment/config.toml:49-74 in
the reference), inter-robot factors live (comms radius covers neighbours).

Metric: factor/variable message updates per second, counted like the
reference's per-node message counters (factorgraph/mod.rs:28-125): every
factor->variable and variable->factor message produced in a pass.

vs_baseline: achieved simulation speed as a multiple of the reference's
real-time contract (10 Hz FixedUpdate) for this robot count — the reference
publishes no absolute throughput numbers (BASELINE.md), so real-time x1 is
the comparable bar its experiments actually ran at (with 30-50 robots).

    python bench.py [sender|receiver|receiver_compact]

`headline_swarm` and `scale_swarm` build this benchmark's two swarm
configurations; chip_smoke.py and bench/scale.py run them too.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def headline_swarm(R: int = 1024, **over):
    """(params, state, sdf) of the headline cell: R=1024, V=21, 50i+10e.
    Another R keeps the robots' spacing on the circle.

    Geometry is sized so the slot capacity COVERS the true in-range degree
    (nbr_overflow must stay 0): radius 800 -> ~4.9 m spacing -> ~20 robots
    within the 50 m comms radius at spawn, rising as the circle contracts.
    Honest degree, honest message counts — connectivity is exact reference
    semantics here, not a truncated approximation."""
    from magics_tpu.core.schedule import ScheduleKind
    from magics_tpu.sim.builder import build_scenario, circle_formation

    speed = 15.0
    kw = dict(
        target_speed=speed,
        planning_horizon=5.0,
        hz=10.0,
        comms_radius=50.0,
        internal=50,
        external=10,
        schedule=ScheduleKind.INTERLEAVE_EVENLY,
        n_slots=32,
        world=(2000.0, 2000.0),
        sdf=np.ones((128, 128)),
        dtype=jnp.float32,
        despawn_on_final_waypoint=False,
        # the Circle Experiment config has no [gbp.factors-enabled] section,
        # and the reference's default disables the tracking factor
        # (gbp_config/src/lib.rs:467-469) — robots steer by waypoint priors
        # alone. Match that workload exactly.
        tracking_enabled=False,
        # receiver-computes exchange: no per-slot outbox gather; equivalent
        # maths (tests/test_receiver_ext)
        ext_exchange="receiver_compact",
        # fused GPU slot kernels: faster end to end than the XLA passes in
        # both bench cells on the H100 (chip_smoke.py phase 5, PERF.md)
        use_pallas=True,
    )
    kw.update(over)
    specs = circle_formation(
        R, circle_radius=800.0 * R / 1024, target_speed=speed
    )
    return build_scenario(specs, **kw)


def scale_swarm(R: int, **over):
    """(params, state, sdf) of the swarm-scale cell: the Circle workload at
    the reference's DEFAULT iteration budget (10 internal + 10 external,
    centered — gbp_config lib.rs:417-426) with grid connectivity.

    Constant linear density on the circle: radius grows with R. 4.9 m
    spacing -> ~20 robots inside the 50 m comms radius, so the 24-slot
    capacity covers the true in-range degree (nbr_overflow must stay 0)."""
    from magics_tpu.core.schedule import ScheduleKind
    from magics_tpu.sim.builder import build_scenario, circle_formation

    speed = 15.0
    circle_radius = max(200.0, R * 4.9 / (2 * np.pi))
    world = 2.6 * circle_radius
    kw = dict(
        target_speed=speed,
        planning_horizon=5.0,
        hz=10.0,
        comms_radius=50.0,
        internal=10,
        external=10,
        schedule=ScheduleKind.CENTERED,
        n_slots=24,
        world=(world, world),
        sdf=np.ones((128, 128)),
        dtype=jnp.float32,
        despawn_on_final_waypoint=False,
        ext_exchange="receiver_compact",
        use_pallas=True,
        grid_cell_size=50.0,
        grid_capacity=32,
        collision_partners=8,
    )
    kw.update(over)
    specs = circle_formation(R, circle_radius=circle_radius, target_speed=speed)
    return build_scenario(specs, **kw)


def messages_per_tick(params, state) -> float:
    """Message updates per tick, reference-style:
      internal slot: factor pass emits 2(V-1) dyn + (V-2) obs + (V-2) trk
      f2v messages; variable pass emits the same number of v2f responses
      plus K_active*(V-1) responses to own inter-robot factors.
      external slot: each active inter-robot factor emits 1 f2v message and
      receives 1 v2f response (2 messages per factor)."""
    R, V = state.prior_mean.shape[:2]
    n_internal = sum(1 for i, _ in params.schedule if i)
    n_external = sum(1 for _, e in params.schedule if e)
    mean_degree = float(jnp.sum(state.nbr_mask) / R)
    per_factor = 0
    if params.dynamic_enabled:
        per_factor += 2 * (V - 1)  # mirrors update_message_counts gating
    if params.obstacle_enabled:
        per_factor += V - 2
    if params.tracking_enabled:
        per_factor += V - 2
    internal_msgs = 2 * per_factor + mean_degree * (V - 1)
    external_msgs = 2 * mean_degree * (V - 1)
    return R * (n_internal * internal_msgs + n_external * external_msgs)


def main() -> None:
    from magics_tpu.compile_cache import enable_compile_cache
    from magics_tpu.graph import tick as T

    enable_compile_cache()
    over = {"ext_exchange": sys.argv[1]} if len(sys.argv) > 1 else {}
    params, state, sdf = headline_swarm(**over)
    R, V = state.prior_mean.shape[:2]

    n_ticks = 20
    run = jax.jit(partial(T.run_ticks, n=n_ticks), static_argnums=2)

    # warmup / compile + let the swarm reach steady state
    state = jax.block_until_ready(run(state, sdf, params))
    state = jax.block_until_ready(run(state, sdf, params))

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        state = jax.block_until_ready(run(state, sdf, params))
    dt = time.perf_counter() - t0
    ticks_per_s = reps * n_ticks / dt

    n_internal = sum(1 for i, _ in params.schedule if i)
    n_external = sum(1 for _, e in params.schedule if e)
    mean_degree = float(jnp.sum(state.nbr_mask) / R)
    overflow = int(np.asarray(state.nbr_overflow))
    msgs_per_s = messages_per_tick(params, state) * ticks_per_s

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "gbp_message_updates_per_s",
                "value": round(msgs_per_s),
                "unit": (
                    f"messages/s (R={R}, V={V}, {n_internal}i+{n_external}e "
                    f"per tick, mean_degree={mean_degree:.1f}, "
                    f"nbr_overflow={overflow})"
                ),
                "vs_baseline": round(ticks_per_s / params.hz, 3),
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
