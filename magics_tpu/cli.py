"""Headless CLI — parity with the reference binary's experiment surface
(crates/magics/src/cli.rs:28-104):

    python -m magics_tpu.cli -i <scenario-name-or-path> [--scenarios-dir DIR]
    python -m magics_tpu.cli --list-scenarios [--scenarios-dir DIR]

plus headless-specific knobs (--seed, --max-time, --export, --dtype).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# --platform choice -> jax_platforms value
PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def interactive_loop(sim, *, quiet: bool = False, live=None,
                     scenarios_dir=None, max_sim_time=None) -> dict:
    """Pause/play + manual stepping REPL over a live simulation.

    Virtual time only advances on `step`/`run` — the paused prompt IS the
    reference's pause state (pause_play.rs:16-47); `step` is manual stepping
    (robot.rs:2448-2519, `manual-step-factor` granularity); `reset` is the
    F5 scenario-reload flow, `load NAME` the F4/F6 scenario-switch flow
    (simulation_loader.rs:594-720: despawn world, swap configs, reseed).
    Commands act on the running device state, so exports/checkpoints
    snapshot mid-run.
    """
    import sys

    import numpy as np

    def status() -> dict:
        import numpy as np

        st = sim.state
        tick = int(np.asarray(st.tick))
        return {
            "ticks": tick,
            "makespan": tick * sim.dt,
            "completed": int(np.asarray(st.completed).sum()),
            "robots": len(sim.specs),
            "rr_collisions": int(np.asarray(st.rr_collisions)),
            "re_collisions": int(np.asarray(st.re_collisions)),
            "nbr_overflow": int(np.asarray(st.nbr_overflow)),
        }

    def emit(msg):
        print(msg, file=sys.stderr, flush=True)

    step_factor = max(1, int(sim.cfg.simulation.manual_step_factor))
    max_ticks = int(sim.max_sim_time * sim.hz)
    emit(
        "interactive: run [seconds] | step [n] | status | export PATH | "
        "checkpoint PATH | reset [seed] | quit"
    )
    while True:
        emit(f"[t={int(np.asarray(sim.state.tick)) * sim.dt:.1f}s paused] > ")
        line = sys.stdin.readline()
        if not line:
            break
        parts = line.split()
        if not parts:
            continue
        cmd, rest = parts[0], parts[1:]
        try:
            if cmd in ("q", "quit", "exit"):
                break
            elif cmd in ("s", "step"):
                n = int(rest[0]) if rest else step_factor
                tick = int(np.asarray(sim.state.tick))
                sim.run(max_ticks=tick + n, chunk_ticks=n,
                        on_chunk=(lambda st, _t: live.push(st)) if live else None)
            elif cmd in ("r", "run"):
                tick = int(np.asarray(sim.state.tick))
                limit = (
                    tick + int(float(rest[0]) * sim.hz) if rest else max_ticks
                )
                sim.run(max_ticks=limit,
                        on_chunk=(lambda st, _t: live.push(st)) if live else None)
            elif cmd == "status":
                import json as _json

                emit(_json.dumps(status()))
            elif cmd == "export" and rest:
                sim.final_tick = int(np.asarray(sim.state.tick))
                sim._harvest_log(sim.state)
                sim.export(rest[0])
                emit(f"exported to {rest[0]}")
            elif cmd == "checkpoint" and rest:
                sim.save_checkpoint(rest[0])
                emit(f"checkpoint: {rest[0]}")
            elif cmd == "save-settings":
                out = sim.save_settings(rest[0] if rest else None)
                emit(f"settings saved to {out}")
            elif cmd == "set" and len(rest) == 2:
                # live config editing with immediate effect (ui/settings.rs):
                # GbpParams is static under jit, so the next step simply
                # compiles against the new value
                from magics_tpu.sim.simulator import apply_live_set

                try:
                    emit(apply_live_set(sim, rest[0], rest[1]))
                except KeyError as ke:
                    emit(str(ke.args[0]))
            elif cmd == "snapshot" and rest:
                from magics_tpu.env.sdf import env_to_image
                from magics_tpu.viz.render import render_trajectories

                sim.final_tick = int(np.asarray(sim.state.tick))
                sim._harvest_log(sim.state)
                export = sim.export()
                obstacle = env_to_image(sim.scenario.environment, expansion=0.0) == 0
                render_trajectories(
                    export, rest[0], obstacle=obstacle,
                    world=sim.scenario.environment.world_size,
                )
                emit(f"snapshot: {rest[0]}")
            elif cmd == "reset":
                sim.reset(seed=int(rest[0]) if rest else None)
                emit("scenario reloaded (F5)")
            elif cmd == "load" and rest and scenarios_dir is not None:
                # scenario SWITCH mid-session (the reference's F4/F6 +
                # Request::Load flow): drop the old world entirely, build
                # the new scenario, reseed from its own prng-seed
                from pathlib import Path

                from magics_tpu.config.loader import load_scenario
                from magics_tpu.sim.simulator import Simulator

                name = " ".join(rest)
                target = Path(name)
                if not target.is_dir():
                    target = Path(scenarios_dir) / name
                # carry the CLI --max-time override across the switch: spec
                # lists pre-materialize repeated spawns out to max-time, so
                # the scenario's own 10,000 s default would build tens of
                # thousands of specs for repeating formations
                sim = Simulator(load_scenario(target), max_sim_time=max_sim_time)
                step_factor = max(1, int(sim.cfg.simulation.manual_step_factor))
                max_ticks = int(sim.max_sim_time * sim.hz)
                if live is not None:
                    live.rebind(sim)
                emit(f"loaded scenario: {sim.scenario.name}")
            elif cmd == "scenarios" and scenarios_dir is not None:
                from magics_tpu.config.loader import list_scenarios

                emit("\n".join(list_scenarios(scenarios_dir)))
            elif cmd in ("h", "help"):
                emit(
                    "run [seconds] — advance virtual time (to max-time "
                    "without an argument); step [n] — advance n ticks "
                    f"(default {step_factor}); status; export PATH; "
                    "snapshot PATH.png; checkpoint PATH; set KEY VALUE "
                    "(live config edit); save-settings [PATH]; "
                    "reset [seed]; load NAME (switch scenario); "
                    "scenarios; quit"
                )
            else:
                emit(f"unknown command: {cmd} (try 'help')")
        except Exception as e:  # keep the session alive on bad input
            emit(f"error: {type(e).__name__}: {e}")

    sim.final_tick = int(np.asarray(sim.state.tick))
    sim._harvest_log(sim.state)
    return status()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="magics-tpu", description=__doc__)
    p.add_argument("-i", "--initial-scenario", help="scenario name or directory path")
    p.add_argument("-l", "--list-scenarios", action="store_true")
    p.add_argument(
        "--scenarios-dir",
        default="./config/scenarios",
        help="directory containing scenario folders (config.toml + *.yaml)",
    )
    p.add_argument(
        "--dump-default",
        choices=["config", "formation", "environment"],
        help="print the default schema document and exit (cli.rs:40-48)",
    )
    p.add_argument(
        "--dump-environment",
        choices=["intersection", "intermediate", "complex", "circle", "maze", "test"],
        help="print a built-in environment preset as YAML (cli.rs:50-53)",
    )
    p.add_argument(
        "--dump-schedule",
        action="store_true",
        help="print the GBP iteration schedule table for the scenario",
    )
    p.add_argument(
        "--schedule-graph",
        action="store_true",
        help="print the FixedUpdate system chain as graphviz DOT and exit "
        "(main.rs:429-458 debugdump parity)",
    )
    p.add_argument("--seed", type=int, default=None, help="override prng-seed")
    p.add_argument("--max-time", type=float, default=None, help="override max sim time (s)")
    p.add_argument("--export", metavar="PATH", help="write JSON export here")
    p.add_argument(
        "--record",
        metavar="DIR",
        help="write a PNG frame sequence of the run (main.rs:460-565 parity)",
    )
    p.add_argument(
        "--snapshot",
        metavar="PNG",
        help="write a trajectory-overview image of the finished run",
    )
    p.add_argument(
        "--player",
        metavar="HTML",
        help="write an interactive playback viewer of the finished run "
        "(viz/player.py — the egui UI / visualiser-plugin equivalent)",
    )
    p.add_argument("--checkpoint", metavar="PATH", help="write checkpoints here")
    p.add_argument(
        "--checkpoint-every",
        type=float,
        metavar="SECONDS",
        help="periodic checkpoint interval in sim seconds",
    )
    p.add_argument("--resume", metavar="PATH", help="resume from a checkpoint")
    p.add_argument(
        "--save-settings",
        metavar="PATH",
        help="serialise the effective Config back to TOML "
        "(simulation_loader.rs:742-763 save_settings parity)",
    )
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument(
        "--platform",
        choices=["gpu", "cpu"],
        default=None,
        help="force a jax backend (default: whatever jax picks)",
    )
    p.add_argument(
        "--profile", metavar="DIR",
        help="capture a jax/XLA device profile of the run into DIR "
        "(view with xprof/tensorboard; the reference's flamegraph/dhat "
        "profiles analog, Cargo.toml:149-152)",
    )
    p.add_argument(
        "--serve", type=int, nargs="?", const=8008, default=None,
        metavar="PORT",
        help="serve a live browser view of the running sim at "
             "http://localhost:PORT (viz/live.py — the headless redesign of "
             "the reference's live view, ui/mod.rs:36-83); composes with "
             "--interactive",
    )
    p.add_argument(
        "--interactive", action="store_true",
        help="drive the simulation from a REPL: pause/step/run virtual time "
        "(pause_play.rs:16-47, manual stepping robot.rs:2448-2519), reload "
        "(F5 flow), export/checkpoint mid-run",
    )
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="increase log verbosity (cli.rs:99-104 parity)",
    )
    p.add_argument(
        "--working-dir", metavar="DIR",
        help="chdir before doing anything else (cli.rs:95-97 parity)",
    )
    args = p.parse_args(argv)

    if args.working_dir:
        import os

        os.chdir(args.working_dir)
    if args.verbose:
        import logging

        logging.basicConfig(
            level=logging.DEBUG if args.verbose > 1 else logging.INFO
        )

    # backend and dtype settings must land before any jax backend touch
    import jax

    from magics_tpu.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", PLATFORMS[args.platform])
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    from magics_tpu.config.loader import list_scenarios, load_scenario

    if args.dump_default:
        from magics_tpu.config import dump

        print(
            {
                "config": dump.default_config_toml,
                "formation": dump.default_formation_yaml,
                "environment": dump.default_environment_yaml,
            }[args.dump_default]()
        )
        return 0

    if args.dump_environment:
        import dataclasses as dc

        import yaml

        from magics_tpu.env.builtin import BUILTINS

        env = BUILTINS[args.dump_environment]()
        doc = {
            "tiles": {
                "grid": env.grid,
                "settings": {
                    "tile-size": env.tile_size,
                    "path-width": env.path_width,
                    "obstacle-height": env.obstacle_height,
                    "sdf": {
                        "resolution": env.sdf.resolution,
                        "expansion": env.sdf.expansion,
                        "blur": env.sdf.blur,
                    },
                },
            },
            "obstacles": [
                {
                    "shape": type(o.shape).__name__.lower(),
                    "rotation": o.rotation,
                    "translation": list(o.translation),
                    "tile": list(o.tile),
                    **{k: v for k, v in dc.asdict(o.shape).items()},
                }
                for o in env.obstacles
            ],
        }
        print(yaml.safe_dump(doc, sort_keys=False, allow_unicode=True))
        return 0

    if args.schedule_graph:
        # the jitted FixedUpdate system chain (graph/tick.py:step; the
        # reference's equivalent chain is robot.rs:86-108)
        systems = [
            ("activate_due_spawns", "spawner timers"),
            ("check_waypoints", "reached_waypoint"),
            ("update_connectivity", "update_robot_neighbours +\\ndelete/create_interrobot_factors"),
            ("update_failed_comms", "Bernoulli antenna flips"),
            ("update_prior_horizon", "update_prior_of_horizon_state"),
            ("update_prior_current", "update_prior_of_current_state_v3"),
            ("iterate_gbp", "iterate_gbp_v2 (schedule)"),
            ("update_message_counts", "message counters"),
            ("update_collisions", "collision hysteresis"),
            ("update_goal_areas", "goal areas"),
            ("log_positions", "position/velocity/belief trackers"),
        ]
        print("digraph fixed_update {")
        print('  rankdir=LR; node [shape=box, fontname="monospace"];')
        for name, label in systems:
            print(f'  {name} [label="{name}\\n({label})"];')
        for (a, _), (b, _) in zip(systems, systems[1:]):
            print(f"  {a} -> {b};")
        print("}")
        return 0

    if args.list_scenarios:
        for name in list_scenarios(args.scenarios_dir):
            print(name)
        return 0

    if not args.initial_scenario:
        p.error("provide -i/--initial-scenario or --list-scenarios")

    path = Path(args.initial_scenario)
    if not path.is_dir():
        path = Path(args.scenarios_dir) / args.initial_scenario
    if not path.is_dir():
        print(f"error: scenario not found: {args.initial_scenario}", file=sys.stderr)
        return 2

    import jax.numpy as jnp

    from magics_tpu.sim.simulator import Simulator

    scenario = load_scenario(path)

    if args.dump_schedule:
        from magics_tpu.core.schedule import schedule_booleans

        sched = scenario.config.gbp.iteration_schedule
        table = schedule_booleans(sched.schedule, sched.internal, sched.external)
        print(f"# {sched.schedule.value}: internal={sched.internal} external={sched.external}")
        print("slot internal external")
        for i, (a, b) in enumerate(table):
            print(f"{i:4d} {str(bool(a)).lower():8s} {str(bool(b)).lower()}")
        return 0

    sim = Simulator(
        scenario,
        seed=args.seed,
        dtype=jnp.float64 if args.dtype == "f64" else jnp.float32,
        max_sim_time=args.max_time,
    )
    if not args.quiet:
        print(
            f"scenario '{scenario.name}': {len(sim.specs)} robots, "
            f"V={sim.params.n_vars}, schedule "
            f"{scenario.config.gbp.iteration_schedule.internal}i+"
            f"{scenario.config.gbp.iteration_schedule.external}e @ {sim.hz} Hz",
            file=sys.stderr,
        )

    t0 = time.perf_counter()

    def progress(tick, n_done):
        if not args.quiet:
            print(
                f"  t={tick / sim.hz:7.1f}s  completed {n_done}/{len(sim.specs)}",
                file=sys.stderr,
            )

    if args.save_settings:
        out = sim.save_settings(args.save_settings)
        if not args.quiet:
            print(f"settings saved to {out}", file=sys.stderr)

    if args.resume:
        sim.resume(args.resume)
        if not args.quiet:
            print(f"resumed from {args.resume}", file=sys.stderr)

    if args.profile:
        import contextlib

        import jax.profiler

        profile_cm = jax.profiler.trace(args.profile)
    else:
        import contextlib

        profile_cm = contextlib.nullcontext()
    live = None
    if args.serve is not None:
        from magics_tpu.viz.live import LiveServer

        live = LiveServer(sim, port=args.serve)
        live.start()
        live.push(sim.state)
        if not args.quiet:
            print(f"live view: http://localhost:{live.port}", file=sys.stderr)
    with profile_cm:
        if args.interactive:
            summary = interactive_loop(
                sim, quiet=args.quiet, live=live,
                scenarios_dir=args.scenarios_dir,
                max_sim_time=args.max_time,
            )
        elif live is not None:
            # control-aware loop: the browser can pause/step/edit the run
            # (finer chunks -> smoother live frames, 0.5 s of sim each)
            summary = live.drive(
                chunk_ticks=5, progress=progress,
                checkpoint_path=args.checkpoint,
                checkpoint_every_s=args.checkpoint_every,
            )
        else:
            summary = sim.run(
                progress=progress,
                checkpoint_path=args.checkpoint,
                checkpoint_every_s=args.checkpoint_every,
            )
    if args.profile and not args.quiet:
        print(f"profile: {args.profile}", file=sys.stderr)
    summary["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(summary))

    if args.checkpoint:
        sim.save_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"checkpoint: {args.checkpoint}", file=sys.stderr)

    if args.export:
        sim.export(args.export)
        if not args.quiet:
            print(f"exported to {args.export}", file=sys.stderr)

    if args.player:
        from magics_tpu.viz.player import build_player

        Path(args.player).write_text(build_player(sim.export()))
        if not args.quiet:
            print(f"player: {args.player}", file=sys.stderr)

    if args.record or args.snapshot:
        from magics_tpu.env.sdf import env_to_image
        from magics_tpu.viz.render import record_frames, render_trajectories

        export = sim.export()
        obstacle = env_to_image(scenario.environment, expansion=0.0) == 0
        world = scenario.environment.world_size
        if args.snapshot:
            render_trajectories(
                export, args.snapshot, obstacle=obstacle, world=world
            )
            if not args.quiet:
                print(f"snapshot: {args.snapshot}", file=sys.stderr)
        if args.record:
            n = record_frames(
                export, args.record, obstacle=obstacle, world=world,
                comms_radius=scenario.config.robot.communication.radius,
            )
            if not args.quiet:
                print(f"recorded {n} frames to {args.record}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
