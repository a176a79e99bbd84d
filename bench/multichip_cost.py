"""Measured multi-chip exchange cost on the virtual CPU mesh.

Runs the robot-sharded tick on an N-virtual-device CPU mesh and MEASURES
(a) the collective traffic per tick from the compiled HLO (sum of
all-gather / all-reduce / collective-permute / all-to-all output bytes —
what actually moves between devices on real hardware), and (b) the
shard_map vs GSPMD step-time ratio. Results feed ARCHITECTURE §9's traffic
table, replacing the modelled numbers.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench/multichip_cost.py [R1,R2,...] [shards1,shards2,...] \
        [sender|receiver_compact|both]

Traffic model being validated (ARCHITECTURE §9): per external pass the
sender path all-gathers the [R, K, V-1, 4] outbox (16·R·K·(V-1) bytes);
the receiver-computes path all-gathers the [R, V-1, 8] compact cavity
tables (32·R·(V-1) bytes) — K-independent, the multi-host fix.
"""

from __future__ import annotations

import os
import re
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8}

_COLLECTIVE_RE = re.compile(
    r"(\w+) = (?:\()?(\w+)\[([\d,]*)\][^)]*?\)? (all-gather|all-reduce|"
    r"collective-permute|all-to-all|reduce-scatter)\(",
)


def collective_bytes(hlo: str) -> dict[str, int]:
    """Sum output bytes of each collective kind in compiled HLO text."""
    out: dict[str, int] = {}
    for m in _COLLECTIVE_RE.finditer(hlo):
        dt, shape, kind = m.group(2), m.group(3), m.group(4)
        n = 1
        for d in shape.split(","):
            if d:
                n *= int(d)
        out[kind] = out.get(kind, 0) + n * _DTYPE_BYTES.get(dt, 4)
    return out


def build(R: int, ext: str):
    from magics_tpu.core.schedule import ScheduleKind
    from magics_tpu.sim.builder import build_scenario, circle_formation

    speed = 15.0
    circle_radius = max(200.0, R * 4.9 / (2 * np.pi))
    world = 2.6 * circle_radius
    specs = circle_formation(R, circle_radius=circle_radius, target_speed=speed)
    return build_scenario(
        specs,
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
        ext_exchange=ext,
        grid_cell_size=50.0,
        grid_capacity=32,
        collision_partners=8,
        collision_log_capacity=0,
        log_every=0,
    )


def measure(R: int, n_shards: int, ext: str, reps: int = 3):
    from magics_tpu.graph import tick as T
    from magics_tpu.parallel import shard_tick as ST
    from magics_tpu.parallel.sharding import make_robot_mesh

    params, state, sdf = build(R, ext)
    mesh = make_robot_mesh(n_shards)

    # ---- shard_map path: explicit collectives ----
    sstate = ST.shard_state(state, mesh)
    ssdf = jax.device_put(sdf, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    step_fn = ST.make_shard_step(mesh, params, state.n_robots)
    lowered = step_fn.lower(sstate, ssdf)
    compiled = lowered.compile()
    traffic = collective_bytes(compiled.as_text())
    # time through the jit wrapper (auto-resharding; zero-size ring buffers
    # come back replicated from the AOT call and would trip the strict path)
    out = step_fn(sstate, ssdf)
    jax.block_until_ready(out.tick)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step_fn(out, ssdf)
    jax.block_until_ready(out.tick)
    t_shard = (time.perf_counter() - t0) / reps * 1e3

    # ---- GSPMD path: same tick, sharded inputs, XLA partitions ----
    from magics_tpu.parallel.sharding import shard_state as gspmd_place

    gstate = gspmd_place(state, mesh)
    gjit = jax.jit(T.step, static_argnums=2)
    gtraffic = collective_bytes(
        gjit.lower(gstate, ssdf, params).compile().as_text()
    )
    gout = gjit(gstate, ssdf, params)
    jax.block_until_ready(gout.tick)
    t0 = time.perf_counter()
    for _ in range(reps):
        gout = gjit(gout, ssdf, params)
    jax.block_until_ready(gout.tick)
    t_gspmd = (time.perf_counter() - t0) / reps * 1e3

    return traffic, t_shard, gtraffic, t_gspmd


def main():
    rs = [1024, 4096, 16384]
    shards = [2, 4, 8]
    exts = ["sender", "receiver_compact"]
    if len(sys.argv) > 1:
        rs = [int(x) for x in sys.argv[1].split(",")]
    if len(sys.argv) > 2:
        shards = [int(x) for x in sys.argv[2].split(",")]
    if len(sys.argv) > 3 and sys.argv[3] != "both":
        exts = [sys.argv[3]]

    n_dev = len(jax.devices())
    print(f"# virtual CPU devices: {n_dev}")
    print("# R  shards  exchange          all_gather_MB/tick  other_MB  "
          "shard_ms  gspmd_ms  ratio")
    for R in rs:
        for ns in shards:
            if ns > n_dev or R % ns:
                continue
            for ext in exts:
                tr, ts, gtr, tg = measure(R, ns, ext)
                ag = tr.get("all-gather", 0) / 1e6
                other = sum(v for k, v in tr.items() if k != "all-gather") / 1e6
                print(
                    f"{R:6d}  {ns}  {ext:16s}  {ag:10.2f}  {other:8.2f}  "
                    f"{ts:8.1f}  {tg:8.1f}  {ts / tg:5.2f}",
                    flush=True,
                )


if __name__ == "__main__":
    main()
