"""Two-process CPU dry run of the multi-host launcher.

Spawns two OS processes that initialise jax.distributed against a local
coordinator, build one global 8-device mesh (4 virtual CPU devices each —
the 2-host topology analogue), run the shard_map tick across it, and print
a replicated checksum of the global positions. Both processes must agree —
the multi-host equivalent of the single-process dryrun.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cpu_mesh_agrees():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(
            MAGICS_COORDINATOR=f"localhost:{port}",
            MAGICS_NUM_PROCESSES="2",
            MAGICS_PROCESS_ID=str(rank),
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_PLATFORMS="",  # let --platform cpu decide
        )
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "magics_tpu.parallel.launch",
                    "--platform", "cpu", "--robots", "64", "--ticks", "3",
                    "--slots", "4", "--internal", "2", "--external", "2",
                    "--check-sum",
                ],
                cwd=REPO,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process launch timed out")
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"

    sums = []
    for out in outs:
        for line in out.splitlines():
            if "abs_pos_sum=" in line:
                sums.append(line.split("abs_pos_sum=")[1].strip())
    assert len(sums) == 2, outs
    assert sums[0] == sums[1], sums
    # the global mesh spanned both processes
    assert any("processes=2 devices=8" in o for o in outs), outs
