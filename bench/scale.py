"""Swarm-scale benchmark: robots planned in real time on one device.

BASELINE.md's north star is >= 10,000 robots inside the simulator's per-tick
deadline. This sweeps R on the Circle workload with the reference's DEFAULT
iteration budget (10 internal + 10 external, centered — gbp_config
lib.rs:417-426) at 10 Hz, using grid connectivity (graph/grid.py) so
neighbour search stays O(R) (bench.scale_swarm). Prints one line per R:
ms/tick and the real-time multiple (10 Hz => 100 ms budget).

    python bench/scale.py [R1,R2,...] [sender|receiver|receiver_compact]

The second argument selects the inter-robot exchange strategy
(GbpParams.ext_exchange); default receiver_compact — the receiver-computes
fast path (no per-slot outbox gather).
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


def main():
    from bench import scale_swarm
    from magics_tpu.compile_cache import enable_compile_cache
    from magics_tpu.graph import tick as T

    enable_compile_cache()
    rs = [1024, 4096, 8192, 16384]
    if len(sys.argv) > 1:
        rs = [int(x) for x in sys.argv[1].split(",")]
    ext = sys.argv[2] if len(sys.argv) > 2 else "receiver_compact"

    for R in rs:
        params, state, sdf = scale_swarm(R, ext_exchange=ext)
        n_ticks = 10
        run = jax.jit(partial(T.run_ticks, n=n_ticks), static_argnums=2)
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state, sdf, params))
        compile_s = time.perf_counter() - t0
        state = jax.block_until_ready(run(state, sdf, params))
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            state = jax.block_until_ready(run(state, sdf, params))
        ms = (time.perf_counter() - t0) / (reps * n_ticks) * 1e3
        rt = 100.0 / ms  # 10 Hz deadline
        print(
            f"R={R:6d}  {ms:8.2f} ms/tick  {rt:7.2f}x real-time  "
            f"(compile {compile_s:.0f}s, mean_degree "
            f"{float(jnp.sum(state.nbr_mask)) / R:.2f}, "
            f"nbr_overflow {int(np.asarray(state.nbr_overflow))}, "
            f"grid_overflow {int(np.asarray(state.grid_overflow))}, "
            f"{jax.devices()[0].device_kind})"
        )


if __name__ == "__main__":
    main()
