"""Component-level timing of the headline bench workload.

Times the full tick and ablations (internal-only / external-only schedules,
the fused GPU slot kernels, grid connectivity) on the same R=1024 Circle-Experiment
configuration as bench.py, so regressions can be localised. Usage:

    python bench/profile_tick.py [R] [--variants a,b,...]

Each variant prints one line: name, ms/tick, ticks/s.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def build(R, *, internal=50, external=10, **over):
    from magics_tpu.core.schedule import ScheduleKind
    from magics_tpu.sim.builder import build_scenario, circle_formation

    speed = 15.0
    specs = circle_formation(R, circle_radius=200.0, target_speed=speed)
    return build_scenario(
        specs,
        target_speed=speed,
        planning_horizon=5.0,
        hz=10.0,
        comms_radius=50.0,
        internal=internal,
        external=external,
        schedule=ScheduleKind.INTERLEAVE_EVENLY,
        n_slots=8,
        world=(500.0, 500.0),
        sdf=np.ones((128, 128)),
        dtype=jnp.float32,
        despawn_on_final_waypoint=False,
        **over,
    )


def time_variant(name, params, state, sdf, n_ticks=20, reps=3):
    from magics_tpu.graph import tick as T

    run = jax.jit(partial(T.run_ticks, n=n_ticks), static_argnums=2)
    t_c0 = time.perf_counter()
    state = jax.block_until_ready(run(state, sdf, params))
    compile_s = time.perf_counter() - t_c0
    state = jax.block_until_ready(run(state, sdf, params))
    t0 = time.perf_counter()
    for _ in range(reps):
        state = jax.block_until_ready(run(state, sdf, params))
    dt = time.perf_counter() - t0
    ms = dt / (reps * n_ticks) * 1e3
    print(f"{name:28s} {ms:9.2f} ms/tick  {1e3 / ms:8.2f} ticks/s  (compile {compile_s:.1f}s)")
    return ms


VARIANTS = {
    "baseline": {},
    "internal_only": dict(internal=50, external=0),
    "external_only": dict(internal=0, external=10),
    "no_gbp": dict(internal=0, external=0),
    "pallas": dict(use_pallas=True),
    "grid": dict(grid_cell_size=50.0, grid_capacity=64, collision_partners=8),
    "scan": dict(scan_schedule=True),
    "no_interrobot": dict(interrobot_enabled=False),
}


def main():
    from magics_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    R = int(args[0]) if args else 1024
    sel = None
    for a in sys.argv[1:]:
        if a.startswith("--variants="):
            sel = a.split("=", 1)[1].split(",")
    for name, over in VARIANTS.items():
        if sel and name not in sel:
            continue
        params, state, sdf = build(R, **over)
        time_variant(name, params, state, sdf)


if __name__ == "__main__":
    main()
