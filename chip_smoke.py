"""Smoke run of the swarm planner on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --four-gpus  # only the sharded swarm on four cards

Phases (one process, one card):
  1. device      JAX's device and the card's name and power limit; no GPU
                 means exit 1 before anything runs
  2. user path   the Circle Experiment's published settings (30 robots,
                 50 internal + 10 external iterations interleaved evenly,
                 10 Hz, 50 m comms radius, 15 m/s) built from the Config
                 schema and driven through Simulator.run with the default
                 "sender" exchange
  3. headline    bench.py's swarm (R=1024, receiver_compact, fused slot
                 kernels) via run_ticks
  4. scale       R=10,240 with grid connectivity at 10i+10e (bench/scale.py)
  5. kernels     the fused slot kernels (kernels/gbp_slot.py) compiled for
                 the card against the XLA passes, one slot at R=1024 and
                 R=10,240, then whole ticks with and without them

`--four-gpus` runs the shard_map tick (parallel/shard_tick.py, XLA passes)
on a 1-D mesh of four cards at R=16,384 and compares its positions with the
same ticks on one card.

Every phase runs its own correctness checks; any failure exits non-zero.
The last line of output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

CARD = ""  # "name, power limit" from nvidia-smi, prefixed to every number


def check(ok, what) -> None:
    """A correctness check that also holds under `python -O`."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def timed(fn, *args, reps: int = 3) -> list[float]:
    """Seconds per call of `fn(*args)`, each ending in block_until_ready."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def peak_bytes() -> int:
    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device() -> None:
    global CARD
    devs = jax.devices()
    print(f"jax.devices(): {devs}", flush=True)
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found platform {devs[0].platform!r}", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    CARD = smi[0].strip()
    print(f"device_kind: {devs[0].device_kind}", flush=True)
    print(f"nvidia-smi: {CARD}", flush=True)


def circle_experiment_scenario():
    """The Circle Experiment at its published settings, from the Config
    schema defaults, a built-in environment and a circle formation."""
    from magics_tpu.config.formation import (
        Formation, FormationGroup, ReachedWhen, Shape, Waypoint,
    )
    from magics_tpu.config.loader import Scenario
    from magics_tpu.config.schema import Config
    from magics_tpu.core.schedule import ScheduleKind
    from magics_tpu.env.builtin import BUILTINS

    cfg = Config()
    cfg.simulation.hz = 10.0
    cfg.simulation.prng_seed = 805
    cfg.simulation.max_time = 30.0
    cfg.gbp.iteration_schedule.internal = 50
    cfg.gbp.iteration_schedule.external = 10
    cfg.gbp.iteration_schedule.schedule = ScheduleKind.INTERLEAVE_EVENLY
    cfg.gbp.sigma_factor_interrobot = 0.005
    cfg.robot.target_speed = 15.0
    cfg.robot.communication.radius = 50.0
    ring = Shape(kind="circle", radius=50.0, center=(0.5, 0.5))
    formation = Formation(
        robots=30, planning_strategy="only-local", initial_shape=ring,
        placement="equal", placement_attempts=1000,
        waypoints=[Waypoint(ring, "cross")], delay_s=0.0,
        repeat_every_s=None, repeat_times=None,
        # waypoints count when the horizon reaches them; the mission ends
        # when the robot itself arrives (a horizon finish would despawn
        # robots half way across)
        waypoint_reached=ReachedWhen(None, "horizon"),
        finished=ReachedWhen(None, "current"),
    )
    return Scenario(
        name="Circle Experiment", config=cfg,
        environment=BUILTINS["circle"](),
        formations=FormationGroup(formations=[formation]),
    )


def phase_user_path() -> None:
    from magics_tpu.sim.simulator import Simulator

    sim = Simulator(circle_experiment_scenario())
    check(sim.params.ext_exchange == "sender", sim.params.ext_exchange)
    pos0 = np.asarray(sim.state.pos)
    goals = np.stack([s.waypoints[-1, :2] for s in sim.specs])
    dist0 = np.linalg.norm(pos0 - goals, axis=1)

    # 4 s in, the robots are mid-crossing and connected; by 300 ticks they
    # have finished and despawned. One 20-tick chunk size: one compile.
    t0 = time.perf_counter()
    sim.run(max_ticks=40, chunk_ticks=20)
    first_s = time.perf_counter() - t0
    st = sim.state
    pos = np.asarray(st.pos)
    check(np.isfinite(pos).all(), "non-finite positions")
    check(bool(np.asarray(st.nbr_mask).any()), "no inter-robot connections")
    closer = np.linalg.norm(pos - goals, axis=1) < dist0 - 10.0
    check(closer.mean() > 0.9, f"only {closer.mean():.2f} of robots progressed")

    t0 = time.perf_counter()
    summary = sim.run(max_ticks=300, chunk_ticks=20)
    second_s = time.perf_counter() - t0
    st = sim.state
    check(np.isfinite(np.asarray(st.pos)).all(), "non-finite positions")
    check(summary["nbr_overflow"] == 0, summary)
    check(summary["grid_overflow"] == 0, summary)
    check(int(np.asarray(st.rr_partner_overflow)) == 0, "rr_partner_overflow")
    runner = sim._runners[20]
    compiled = runner.lower(
        sim.state, sim.sdf, sim.params, env_dist=sim.env_dist
    ).compile()
    check(summary["completed"] > 0, summary)
    say(f"phase 2 user path: {summary}")
    say(f"phase 2 first 40 ticks {first_s:.3f} s (compile included), "
        f"ticks 40-{summary['ticks']} {second_s:.3f} s")
    say(f"phase 2 memory_analysis: {compiled.memory_analysis()}")
    say(f"phase 2 peak_bytes_in_use: {peak_bytes()}")


def run_swarm(params, state, sdf, n_ticks: int, reps: int = 3):
    """Compile, warm up and time `n_ticks`-tick chunks; returns
    (state, compile seconds, per-rep ms/tick, the jitted runner)."""
    from magics_tpu.graph import tick as T

    run = jax.jit(partial(T.run_ticks, n=n_ticks), static_argnums=2)
    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state, sdf, params))
    compile_s = time.perf_counter() - t0
    state = jax.block_until_ready(run(state, sdf, params))
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state, sdf, params))
        ms.append((time.perf_counter() - t0) / n_ticks * 1e3)
    return state, compile_s, ms, run


def check_swarm(state, tag: str) -> None:
    check(int(np.asarray(state.nbr_overflow)) == 0, f"{tag}: nbr_overflow")
    check(int(np.asarray(state.grid_overflow)) == 0, f"{tag}: grid_overflow")
    for f in ("belief_mean", "belief_eta", "pos"):
        check(np.isfinite(np.asarray(getattr(state, f))).all(), f"{tag}: {f}")
    check(bool(np.asarray(state.nbr_mask).any()), f"{tag}: no connections")


def phase_headline(R: int = 1024, **over):
    from bench import headline_swarm, messages_per_tick

    params, state, sdf = headline_swarm(R, **over)
    state, compile_s, ms, run = run_swarm(params, state, sdf, 20)
    check_swarm(state, "headline")
    msgs = messages_per_tick(params, state)
    say(f"phase 3 headline R={R} 50i+10e receiver_compact use_pallas="
        f"{params.use_pallas}: compile "
        f"{compile_s:.1f} s, ms/tick {[round(m, 3) for m in ms]}, "
        f"median {np.median(ms):.3f} ms = {100.0 / np.median(ms):.2f}x real "
        f"time, {msgs * 1e3 / np.median(ms):.4g} message updates/s, "
        f"mean degree {float(np.asarray(state.nbr_mask).sum()) / R:.1f}")
    return params, state, sdf, run


def phase_scale(R: int = 10240, **over):
    from bench import scale_swarm

    params, state, sdf = scale_swarm(R, **over)
    state, compile_s, ms, run = run_swarm(params, state, sdf, 10)
    check_swarm(state, "scale")
    say(f"phase 4 scale R={R} 10i+10e grid use_pallas={params.use_pallas}: "
        f"compile {compile_s:.1f} s, "
        f"ms/tick {[round(m, 3) for m in ms]}, median {np.median(ms):.3f} ms "
        f"= {100.0 / np.median(ms):.2f}x real time, peak_bytes_in_use "
        f"{peak_bytes()}")
    return params, state, sdf, run


def _one_slot(state, sdf, params):
    from magics_tpu.graph import tick as T

    state = T.internal_factor_pass(state, sdf, params)
    return T.internal_variable_pass(state, params)


def check_slot(params, state, sdf, tag: str, interpret: bool = False,
               n_slots: int = 20):
    """One internal slot through the kernels vs the XLA passes, on a state
    that has run some ticks; then `n_slots` slots in one jitted loop of
    each, timed in turns. Returns (XLA ms, kernel ms) per slot."""
    import dataclasses

    from magics_tpu.kernels.gbp_slot import slot_mismatches

    px = dataclasses.replace(params, use_pallas=False)
    pk = dataclasses.replace(params, use_pallas=True, pallas_interpret=interpret)

    def slots(state, sdf, p):
        return jax.lax.fori_loop(
            0, n_slots, lambda _, st: _one_slot(st, sdf, p), state
        )

    with jax.default_matmul_precision("highest"):
        one = jax.jit(_one_slot, static_argnums=2)
        ref = jax.block_until_ready(one(state, sdf, px))
        got = jax.block_until_ready(one(state, sdf, pk))
        bad = slot_mismatches(ref, got)
        check(bad == [], f"{tag}: kernel disagrees with XLA: {bad}")
        loop = jax.jit(slots, static_argnums=2)
        jax.block_until_ready((loop(state, sdf, px), loop(state, sdf, pk)))
        t = {"xla": [], "kernels": []}
        for name in ("xla", "kernels", "kernels", "xla"):
            p = px if name == "xla" else pk
            t[name] += timed(loop, state, sdf, p, reps=3)
    ms = {k: float(np.median(v)) * 1e3 / n_slots for k, v in t.items()}
    say(f"phase 5 one slot {tag}: agrees with XLA within SLOT_TOLERANCE; "
        f"{n_slots} slots in a loop: XLA {ms['xla']:.4f} ms/slot, kernels "
        f"{ms['kernels']:.4f} ms/slot")
    return ms


def compare_ticks(params, state, sdf, n_ticks: int, tag: str, run,
                  interpret: bool = False) -> dict:
    """Whole ticks with the kernels off and on, timed in turns (XLA,
    kernels, kernels, XLA) on one card. `run` is the compiled runner of
    `params`; the other variant is compiled here."""
    import dataclasses

    variants = {
        "xla": dataclasses.replace(params, use_pallas=False),
        "kernels": dataclasses.replace(
            params, use_pallas=True, pallas_interpret=interpret
        ),
    }
    runs = {}
    for name, p in variants.items():
        if p == params:
            runs[name] = run
            continue
        st, compile_s, _, runs[name] = run_swarm(p, state, sdf, n_ticks, reps=0)
        check_swarm(st, f"{tag} {name}")
        say(f"phase 5 {tag} {name}: compile {compile_s:.1f} s")
    ms = {"xla": [], "kernels": []}
    for name in ("xla", "kernels", "kernels", "xla"):
        t = timed(runs[name], state, sdf, variants[name], reps=3)
        ms[name] += [x / n_ticks * 1e3 for x in t]
    med = {k: float(np.median(v)) for k, v in ms.items()}
    say(f"phase 5 whole tick {tag}: XLA {med['xla']:.3f} ms/tick, kernels "
        f"{med['kernels']:.3f} ms/tick (per rep: {ms})")
    return med


def phase_kernels(headline, scale, interpret: bool = False) -> None:
    (hp, hs, hsdf, hrun), (sp, ss, ssdf, srun) = headline, scale
    hr, sr = hs.pos.shape[0], ss.pos.shape[0]
    check_slot(hp, hs, hsdf, f"R={hr}", interpret)
    check_slot(sp, ss, ssdf, f"R={sr}", interpret)
    h = compare_ticks(hp, hs, hsdf, 20, f"R={hr} 50i+10e", hrun, interpret)
    s = compare_ticks(sp, ss, ssdf, 10, f"R={sr} 10i+10e", srun, interpret)
    wins = h["kernels"] < h["xla"] and s["kernels"] < s["xla"]
    say(f"phase 5 decision: kernels faster end to end in both cells: {wins}")


def phase_four_gpus(R: int = 16384, n_ticks: int = 5) -> None:
    """The shard_map tick over a 1-D mesh of four cards vs one card."""
    from bench import scale_swarm
    from magics_tpu.graph import tick as T
    from magics_tpu.parallel import shard_tick as ST
    from magics_tpu.parallel.sharding import make_robot_mesh, replicate

    devs = jax.devices()
    check(len(devs) == 4 and all(d.platform == "gpu" for d in devs), devs)
    # the sharded path as users run it across cards: XLA passes and the
    # receiver_compact exchange
    params, state, sdf = scale_swarm(R, use_pallas=False)
    check(params.ext_exchange == "receiver_compact", params.ext_exchange)

    one = jax.jit(partial(T.run_ticks, n=n_ticks), static_argnums=2)
    s1, d1 = jax.device_put((state, sdf), devs[0])
    t0 = time.perf_counter()
    ref = jax.block_until_ready(one(s1, d1, params))
    one_compile = time.perf_counter() - t0
    one_ms = np.median(timed(one, s1, d1, params)) / n_ticks * 1e3

    mesh = make_robot_mesh(4)
    st = ST.shard_state(state, mesh)
    sdf_r = replicate(sdf, mesh)
    step = ST.make_shard_step(mesh, params, R, n_ticks=n_ticks)
    t0 = time.perf_counter()
    out = jax.block_until_ready(step(st, sdf_r))
    four_compile = time.perf_counter() - t0
    four_ms = np.median(timed(step, st, sdf_r)) / n_ticks * 1e3

    check_swarm(out, "four cards")
    a, b = np.asarray(ref.pos), np.asarray(out.pos)
    err = float(np.abs(a - b).max())
    check(np.allclose(b, a, rtol=1e-4, atol=1e-4), f"max |diff| {err}")
    say(f"four cards R={R} ({R // 4}/card) {n_ticks} ticks receiver_compact: "
        f"positions agree with one card, max |diff| {err:.3g} m (tol 1e-4); "
        f"one card {one_ms:.3f} ms/tick (compile {one_compile:.1f} s), four "
        f"cards {four_ms:.3f} ms/tick (compile {four_compile:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded swarm on four cards")
    args = ap.parse_args(argv)

    from magics_tpu.compile_cache import enable_compile_cache

    cache = enable_compile_cache()  # before anything compiles
    phase_device()
    try:
        import yaml  # noqa: F401
        have_yaml = True
    except ImportError:
        have_yaml = False
    print(f"compile cache: {cache}; PyYAML present: "
          f"{have_yaml}", flush=True)

    if args.four_gpus:
        phase_four_gpus()
    else:
        phase_user_path()
        headline = phase_headline()
        scale = phase_scale()
        phase_kernels(headline, scale)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
