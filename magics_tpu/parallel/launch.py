"""Multi-process launcher: `jax.distributed` entry point for the swarm tick.

Every process runs this same program; `initialize()` wires jax.distributed
from the environment, after which `jax.devices()` spans every process's
devices and the existing mesh machinery (parallel/sharding.py,
parallel/shard_tick.py) works unchanged — the robot-axis all_gather runs
over NVLink between the cards of a host and over the network between hosts,
with XLA routing the hierarchy. No rendezvous code of our own: the launcher
is environment-driven so it composes with any scheduler that can export
three variables.

Environment (leave all unset for a single-process run, which drives every
local device from one process):
    MAGICS_COORDINATOR   host:port of process 0 (jax.distributed coordinator)
    MAGICS_NUM_PROCESSES total process count
    MAGICS_PROCESS_ID    this process's rank

When the processes share one host (coordinator on localhost), process i
drives GPU i only, so no two processes open the same card.

Usage:
    # one process per host
    python -m magics_tpu.parallel.launch --robots 16384 --ticks 50

Multi-process CPU dry run (used by tests/test_multiprocess_launch.py):
    MAGICS_COORDINATOR=localhost:9911 MAGICS_NUM_PROCESSES=2 \
    MAGICS_PROCESS_ID=0 XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python -m magics_tpu.parallel.launch --platform cpu --robots 64 ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from magics_tpu.cli import PLATFORMS
from magics_tpu.compile_cache import enable_compile_cache


def initialize(platform: str | None = None) -> None:
    """Initialise jax.distributed from the environment.

    Single-process runs (no coordinator configured) skip initialisation. A
    failed rendezvous raises: a multi-process run must never quietly
    continue at a smaller world size.
    """
    import jax

    if platform:
        jax.config.update("jax_platforms", PLATFORMS[platform])

    coord = os.environ.get("MAGICS_COORDINATOR")
    nproc = os.environ.get("MAGICS_NUM_PROCESSES")
    pid = os.environ.get("MAGICS_PROCESS_ID")
    if not (coord and nproc is not None and pid is not None):
        return
    shared_host = coord.split(":")[0] in ("localhost", "127.0.0.1")
    local_ids = [int(pid)] if shared_host and platform != "cpu" else None
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
        local_device_ids=local_ids,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--robots", type=int, default=1024)
    p.add_argument("--ticks", type=int, default=20)
    p.add_argument("--slots", type=int, default=24)
    p.add_argument("--internal", type=int, default=10)
    p.add_argument("--external", type=int, default=10)
    p.add_argument("--platform", choices=sorted(PLATFORMS), default=None)
    p.add_argument(
        "--check-sum", action="store_true",
        help="print a deterministic checksum of the final positions "
        "(cross-process agreement check for the dry-run test)",
    )
    args = p.parse_args(argv)

    initialize(args.platform)
    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from magics_tpu.parallel import shard_tick as ST
    from magics_tpu.parallel.sharding import make_robot_mesh, replicate
    from magics_tpu.sim.builder import build_scenario, circle_formation

    devices = jax.devices()
    n_dev = len(devices)
    rank = jax.process_index()
    if rank == 0:
        print(
            f"processes={jax.process_count()} devices={n_dev} "
            f"({devices[0].platform})",
            flush=True,
        )

    R = args.robots - (args.robots % n_dev) or n_dev
    speed = 15.0
    circle_radius = max(200.0, R * 4.9 / (2 * np.pi))
    specs = circle_formation(R, circle_radius=circle_radius, target_speed=speed)
    params, state, sdf = build_scenario(
        specs,
        target_speed=speed,
        planning_horizon=5.0,
        hz=10.0,
        comms_radius=50.0,
        internal=args.internal,
        external=args.external,
        n_slots=args.slots,
        world=(2.6 * circle_radius, 2.6 * circle_radius),
        dtype=jnp.float32,
        despawn_on_final_waypoint=False,
        grid_cell_size=50.0,
        grid_capacity=32,
        collision_partners=8,
    )

    mesh = make_robot_mesh(n_dev)
    st = ST.shard_state(state, mesh)
    sdf_r = replicate(sdf, mesh)
    step = ST.make_shard_step(mesh, params, R, n_ticks=args.ticks)

    t0 = time.perf_counter()
    out = step(st, sdf_r)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = step(out, sdf_r)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    ms = dt / args.ticks * 1e3

    if rank == 0:
        print(
            f"R={R} shards={n_dev} {ms:.2f} ms/tick "
            f"({100.0 / ms:.2f}x 10 Hz real-time, compile {compile_s:.0f}s)",
            flush=True,
        )
    if args.check_sum:
        # reduce the global sharded positions to a replicated scalar — every
        # process must print the identical value (cross-process agreement)
        from jax.sharding import NamedSharding, PartitionSpec as P

        total = jax.jit(
            lambda x: jnp.abs(x).sum(),
            out_shardings=NamedSharding(mesh, P()),
        )(out.pos)
        print(f"rank={rank} abs_pos_sum={float(total):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
