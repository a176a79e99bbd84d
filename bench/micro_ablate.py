"""Ablate individual tick systems by monkeypatching them to identity.

step() resolves its helpers through module globals at call time, so replacing
e.g. tick.external_factor_pass with a no-op removes exactly that system from
the compiled program. The time delta vs baseline localises the cost of each
system in the *fused* program (component micro-benchmarks mislead: XLA fuses
and CSEs across systems). Usage:

    python bench/micro_ablate.py [R] [--variants a,b,...] [--pallas]

`--pallas` runs the GBP passes' arithmetic in the fused GPU kernels
(GbpParams.use_pallas).
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from profile_tick import build


def _identity(state, *a, **k):
    return state


ABLATIONS = {
    "baseline": [],
    "no_ext_factor": ["external_factor_pass"],
    "no_ext_var": ["external_variable_pass"],
    "no_collisions": ["update_collisions", "update_collisions_grid"],
    "no_counts_log": ["update_message_counts", "log_positions"],
    "no_priors": ["update_prior_horizon", "update_prior_current"],
    "no_waypoints_goals": ["check_waypoints", "update_goal_areas"],
    "no_connectivity": ["update_connectivity", "update_connectivity_grid"],
}


def main():
    from magics_tpu.compile_cache import enable_compile_cache
    from magics_tpu.graph import tick as T

    enable_compile_cache()

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    R = int(args[0]) if args else 1024
    sel = None
    for a in sys.argv[1:]:
        if a.startswith("--variants="):
            sel = a.split("=", 1)[1].split(",")

    p, state0, sdf = build(R, use_pallas="--pallas" in sys.argv)
    saved = {}
    results = {}
    for name, victims in ABLATIONS.items():
        if sel and name not in sel:
            continue
        for v in victims:
            saved[v] = getattr(T, v)
            setattr(T, v, _identity)
        try:
            run = jax.jit(partial(T.run_ticks, n=20), static_argnums=2)
            state = jax.block_until_ready(run(state0, sdf, p))
            state = jax.block_until_ready(run(state, sdf, p))
            t0 = time.perf_counter()
            for _ in range(3):
                state = jax.block_until_ready(run(state, sdf, p))
            dt = time.perf_counter() - t0
            ms = dt / 60 * 1e3
            results[name] = ms
            base = results.get("baseline")
            delta = (
                f"  (saves {base - ms:+.2f} ms)"
                if base and name != "baseline"
                else ""
            )
            print(f"{name:22s} {ms:8.2f} ms/tick{delta}", flush=True)
        finally:
            for v, fn in saved.items():
                setattr(T, v, fn)
            saved.clear()


if __name__ == "__main__":
    main()
