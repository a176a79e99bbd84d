"""Browser -> sim control channel of the live view (viz/live.py).

The reference runs its simulator under an egui UI with live pause/play
(pause_play.rs:16-47), manual stepping (robot.rs:2448-2519) and a settings
panel that edits the running config (ui/settings.rs). The headless
redesign serves the same controls over HTTP: POST /cmd enqueues commands
that LiveServer.drive() consumes between device chunks.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from magics_tpu.config.loader import load_scenario
from magics_tpu.sim.simulator import Simulator
from magics_tpu.viz.live import LiveServer

REF_SCENARIOS = "/root/reference/config/scenarios"


def _post(port: int, cmd: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/cmd",
        data=json.dumps(cmd).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def served():
    sc = load_scenario(f"{REF_SCENARIOS}/Junction Experiment")
    sim = Simulator(sc, max_sim_time=6.0)
    live = LiveServer(sim, port=0)  # ephemeral port
    live.start()
    # start paused so the test owns virtual time from tick 0
    live.submit({"op": "pause"})
    t = threading.Thread(target=live.drive, kwargs={"chunk_ticks": 2})
    t.start()
    yield sim, live, t
    live.submit({"op": "quit"})
    t.join(timeout=60)
    live.stop()
    assert not t.is_alive()


def _wait_tick(sim, pred, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred(int(np.asarray(sim.state.tick))):
            return int(np.asarray(sim.state.tick))
        time.sleep(0.05)
    raise AssertionError(
        f"timeout; tick={int(np.asarray(sim.state.tick))}"
    )


def test_pause_holds_virtual_time(served):
    sim, live, _t = served
    assert _get(live.port, "/status.json")["paused"] is True
    tick0 = int(np.asarray(sim.state.tick))
    time.sleep(0.6)
    assert int(np.asarray(sim.state.tick)) == tick0


def test_step_advances_exactly_n_while_paused(served):
    sim, live, _t = served
    tick0 = int(np.asarray(sim.state.tick))
    assert _post(live.port, {"op": "step", "n": 3})["ok"]
    _wait_tick(sim, lambda t: t == tick0 + 3)
    time.sleep(0.4)  # still paused: no further advance
    assert int(np.asarray(sim.state.tick)) == tick0 + 3


def test_set_edits_params_between_chunks(served):
    sim, live, _t = served
    assert _post(
        live.port, {"op": "set", "key": "comms-radius", "value": "33.5"}
    )["ok"]
    _post(live.port, {"op": "step", "n": 1})
    tick0 = int(np.asarray(sim.state.tick))
    _wait_tick(sim, lambda t: t >= tick0)
    # applied before the step ran (queue order is FIFO)
    deadline = time.monotonic() + 10
    while sim.params.comms_radius != 33.5 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert sim.params.comms_radius == 33.5


def test_bad_command_rejected(served):
    _sim, live, _t = served
    assert _post(live.port, {"op": "nonsense"})["ok"] is False


def test_resume_runs_to_completion_or_cap(served):
    sim, live, thread = served
    assert _post(live.port, {"op": "resume"})["ok"]
    # the drive loop finishes on its own (completion or max-time cap)
    thread.join(timeout=120)
    assert not thread.is_alive()
    max_ticks = int(sim.max_sim_time * sim.hz)
    tick = int(np.asarray(sim.state.tick))
    done = int(np.asarray(sim.state.completed).sum())
    assert tick >= max_ticks or done == len(sim.specs)
