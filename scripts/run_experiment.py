"""Experiment sweep runner — the reference's fish harness as one script.

Mirrors scripts/run-circle-expertiment.fish (seeds 0/31/227/252/805, robot
counts 5..50 step 5) and its siblings: for every (seed, robot-count) cell it
runs the scenario headless to completion, writes the JSON export, and folds
the offline metrics (makespan, LDJ, distance travelled, path deviation —
magics_tpu/analysis.py) into one summary JSON for plotting.

    python scripts/run_experiment.py "Circle Experiment" \
        --scenarios-dir /path/to/config/scenarios \
        --seeds 0,31,227,252,805 --robots 5:50:5 --out results/
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scenario")
    p.add_argument("--scenarios-dir", default="/root/reference/config/scenarios")
    p.add_argument("--seeds", default="0,31,227,252,805")
    p.add_argument("--robots", default=None,
                   help="start:stop:step sweep of the first formation's robot "
                        "count (e.g. 5:50:5); default: scenario as-is")
    p.add_argument("--max-time", type=float, default=None)
    p.add_argument("--failure-rates", default=None,
                   help="comma list sweeping robot.communication.failure-rate "
                        "(the reference's comms-failure harness sweeps "
                        "0.0..0.7, run-communication-failure-expertiment.fish)")
    p.add_argument("--target-speeds", default=None,
                   help="comma list sweeping robot.target-speed (the "
                        "reference's comms-failure harness sweeps v0 10,15)")
    p.add_argument("--schedules", default=None,
                   help="comma list sweeping gbp.iteration-schedule.schedule "
                        "(run-schedules-experiment.fish sweeps all five kinds)")
    p.add_argument("--internals", default=None,
                   help="comma list sweeping gbp.iteration-schedule.internal "
                        "(run-iteration-amount-experiment.fish: fibonacci)")
    p.add_argument("--externals", default=None,
                   help="comma list sweeping gbp.iteration-schedule.external")
    p.add_argument("--comms-radii", default=None,
                   help="comma list sweeping robot.communication.radius "
                        "(run-varying-network-connectivity: 20,40,60,80)")
    p.add_argument("--tracking", default=None,
                   help="comma list of true/false sweeping "
                        "gbp.factors-enabled.tracking (solo/collab GP)")
    p.add_argument("--sigma-trackings", default=None,
                   help="comma list sweeping gbp.sigma-factor-tracking")
    p.add_argument("--preplan", action="store_true",
                   help="pre-plan rrt-star routes at build time instead of "
                        "in-flight (Simulator(inflight_planning=False)): "
                        "in-flight plan application depends on host "
                        "wall-clock vs the poll cadence, so same-seed sweep "
                        "rows are only reproducible with this flag")
    p.add_argument("--out", default="experiment-out")
    p.add_argument("--platform", choices=["gpu", "cpu"], default=None)
    args = p.parse_args(argv)

    import jax

    from magics_tpu.cli import PLATFORMS
    from magics_tpu.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", PLATFORMS[args.platform])
    enable_compile_cache()

    from magics_tpu.analysis import analyse
    from magics_tpu.config.loader import load_scenario
    from magics_tpu.sim.simulator import Simulator

    seeds = [int(s) for s in args.seeds.split(",")]
    if args.robots:
        a, b, c = (int(x) for x in args.robots.split(":"))
        robot_counts = list(range(a, b + 1, c))
    else:
        robot_counts = [None]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    base = load_scenario(Path(args.scenarios_dir) / args.scenario)

    failure_rates = (
        [float(x) for x in args.failure_rates.split(",")]
        if args.failure_rates
        else [None]
    )

    speeds = (
        [float(x) for x in args.target_speeds.split(",")]
        if args.target_speeds
        else [None]
    )
    schedules = args.schedules.split(",") if args.schedules else [None]
    internals = (
        [int(x) for x in args.internals.split(",")] if args.internals else [None]
    )
    externals = (
        [int(x) for x in args.externals.split(",")] if args.externals else [None]
    )
    radii = (
        [float(x) for x in args.comms_radii.split(",")]
        if args.comms_radii else [None]
    )
    trackings = (
        [x.strip().lower() == "true" for x in args.tracking.split(",")]
        if args.tracking else [None]
    )
    sigma_trk = (
        [float(x) for x in args.sigma_trackings.split(",")]
        if args.sigma_trackings else [None]
    )

    summary: list[dict] = []
    for n in robot_counts:
     for v0 in speeds:
      for sk in schedules:
       for it in internals:
        for ex in externals:
         for cr in radii:
          for tk in trackings:
           for stk in sigma_trk:
            for fr in failure_rates:
             for seed in seeds:
                sc = copy.deepcopy(base)
                if cr is not None:
                    sc.config.robot.communication.radius = cr
                if tk is not None:
                    sc.config.gbp.factors_enabled.tracking = tk
                if stk is not None:
                    sc.config.gbp.sigma_factor_tracking = stk
                if n is not None:
                    sc.formations.formations[0].robots = n
                if fr is not None:
                    sc.config.robot.communication.failure_rate = fr
                if v0 is not None:
                    sc.config.robot.target_speed = v0
                if sk is not None:
                    from magics_tpu.core.schedule import ScheduleKind

                    sc.config.gbp.iteration_schedule.schedule = ScheduleKind(sk)
                if it is not None:
                    sc.config.gbp.iteration_schedule.internal = it
                if ex is not None:
                    sc.config.gbp.iteration_schedule.external = ex
                t0 = time.perf_counter()
                sim = Simulator(sc, seed=seed, max_sim_time=args.max_time,
                                viz_log=False,
                                inflight_planning=not args.preplan)
                result = sim.run()
                tag = f"{args.scenario.replace(' ', '-')}_r{n or 'cfg'}" + (
                    f"_v{v0:g}" if v0 is not None else ""
                ) + (
                    f"_k{sk}" if sk is not None else ""
                ) + (
                    f"_i{it}" if it is not None else ""
                ) + (
                    f"_e{ex}" if ex is not None else ""
                ) + (
                    f"_c{cr:g}" if cr is not None else ""
                ) + (
                    f"_t{int(tk)}" if tk is not None else ""
                ) + (
                    f"_g{stk:g}" if stk is not None else ""
                ) + (
                    f"_f{fr}" if fr is not None else ""
                ) + f"_s{seed}"
                export = sim.export(out_dir / f"export_{tag}.json")
                metrics = analyse(export)
                metrics.pop("per_robot", None)
                row = {
                    "robots": n or len(sim.specs),
                    "seed": seed,
                    "wall_s": round(time.perf_counter() - t0, 2),
                    **result,
                    "metrics": metrics,
                }
                if fr is not None:
                    row["failure_rate"] = fr
                if v0 is not None:
                    row["target_speed"] = v0
                if sk is not None:
                    row["schedule"] = sk
                if it is not None:
                    row["internal"] = it
                if ex is not None:
                    row["external"] = ex
                if cr is not None:
                    row["comms_radius"] = cr
                if tk is not None:
                    row["tracking"] = tk
                if stk is not None:
                    row["sigma_tracking"] = stk
                summary.append(row)
                print(json.dumps(row))

    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(f"wrote {out_dir / 'summary.json'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
