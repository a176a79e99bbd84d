"""Receiver-computes inter-robot exchange (params.ext_exchange) vs the
sender-outbox path.

"receiver" recomputes each incoming message on the receiving robot with the
IDENTICAL arithmetic the sender would have used (gathered snapshot rows +
a locally-maintained mirror of what the peer holds) — every shared state
field must be BIT-identical to the sender path across churn, comms-failure
gating, prior changes and despawns. "receiver_compact" is the
Sherman-Morrison rearrangement — numerically equivalent, asserted to tight
f64 tolerances plus identical qualitative outcomes.

The mode-reinterpreted tables (state.py: ir_v2f_ext_pos / ir_int_seeded are
mirrors in receiver modes, ir_f2v_ext is unused) are excluded from the
field-by-field comparison by design.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magics_tpu.graph import tick as T
from magics_tpu.sim.builder import build_scenario, circle_formation

# fields whose semantics differ by exchange mode (state.py)
MODE_PRIVATE = {"ir_v2f_ext_pos", "ir_int_seeded", "ir_f2v_ext"}


def _build(mode: str, R=12, failure=0.3, dtype=jnp.float64):
    specs = circle_formation(R, circle_radius=18.0, target_speed=8.0)
    return build_scenario(
        specs,
        target_speed=8.0,
        planning_horizon=2.0,
        hz=10.0,
        comms_radius=22.0,        # partial coverage -> slot churn during the run
        comms_failure_rate=failure,
        internal=4,
        external=3,
        n_slots=6,                # below full degree -> overflow paths exercised
        dtype=dtype,
        ext_exchange=mode,
    )


def _run_pair(mode_b: str, n_ticks=45, failure=0.3, dtype=jnp.float64):
    pa, sa, sdf = _build("sender", failure=failure, dtype=dtype)
    pb, sb, _ = _build(mode_b, failure=failure, dtype=dtype)
    step = jax.jit(T.step, static_argnums=2)
    states = []
    for _ in range(n_ticks):
        sa = step(sa, sdf, pa)
        sb = step(sb, sdf, pb)
        states.append((sa, sb))
    return states


def test_receiver_exact_bit_parity():
    states = _run_pair("receiver")
    for t, (sa, sb) in enumerate(states):
        for fld in dataclasses.fields(sa):
            if fld.name in MODE_PRIVATE:
                continue
            a = np.asarray(getattr(sa, fld.name))
            b = np.asarray(getattr(sb, fld.name))
            np.testing.assert_array_equal(
                a, b, err_msg=f"tick {t} field {fld.name} diverged"
            )
    # the exchange actually happened (inboxes are not trivially empty)
    sa = states[-1][0]
    assert float(np.abs(np.asarray(sa.ext_inbox)).sum()) > 0.0


def test_receiver_exact_bit_parity_f32():
    """Production dtype: identical arithmetic must stay bit-equal in f32."""
    states = _run_pair("receiver", n_ticks=30, dtype=jnp.float32)
    for t, (sa, sb) in enumerate(states):
        for fld in ("pos", "belief_mean", "ext_inbox", "rr_collisions",
                    "completed", "nbr_mask", "msg_counts"):
            a = np.asarray(getattr(sa, fld))
            b = np.asarray(getattr(sb, fld))
            np.testing.assert_array_equal(
                a, b, err_msg=f"tick {t} field {fld} diverged"
            )


def test_receiver_compact_equivalence():
    """The Sherman-Morrison fast path tracks the sender path to f64
    roundoff while beliefs are conditioned, and reaches the same outcome."""
    states = _run_pair("receiver_compact", n_ticks=60, failure=0.0)
    # trajectory agreement: position drift stays tiny over the whole run
    # (any real divergence in the message maths would amplify through the
    # crossing like the chaotic parity cases do — by tens of meters)
    worst = 0.0
    for sa, sb in states:
        worst = max(
            worst,
            float(np.max(np.abs(np.asarray(sa.pos) - np.asarray(sb.pos)))),
        )
    assert worst < 1e-5, worst
    sa, sb = states[-1]
    np.testing.assert_array_equal(
        np.asarray(sa.completed), np.asarray(sb.completed)
    )
    assert int(np.asarray(sa.rr_collisions)) == int(np.asarray(sb.rr_collisions))


def test_receiver_with_grid_and_despawn():
    """Receiver mode composes with the spatial grid; robots despawn on
    completion identically to the sender path."""
    R = 10
    specs = circle_formation(R, circle_radius=10.0, target_speed=8.0)
    kw = dict(
        target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=30.0,
        internal=3, external=2, n_slots=R - 1, dtype=jnp.float64,
        grid_cell_size=15.0, grid_capacity=16, collision_partners=R - 1,
    )
    pa, sa, sdf = build_scenario(specs, ext_exchange="sender", **kw)
    pb, sb, _ = build_scenario(specs, ext_exchange="receiver", **kw)
    step = jax.jit(T.step, static_argnums=2)
    for t in range(60):
        sa = step(sa, sdf, pa)
        sb = step(sb, sdf, pb)
        np.testing.assert_array_equal(
            np.asarray(sa.pos), np.asarray(sb.pos), err_msg=f"tick {t}"
        )
        np.testing.assert_array_equal(
            np.asarray(sa.active), np.asarray(sb.active), err_msg=f"tick {t}"
        )
    assert bool(np.asarray(sa.completed).all())
