"""Fused GBP slot kernels (kernels/gbp_slot.py) vs the XLA passes.

On the CPU the kernels run in Pallas interpreter mode; one slot of each path
must agree to float32 roundoff, field by field. The CUDA lowering test
checks, without a card, that the kernels pass Pallas's Triton lowering at
the headline width (power-of-two values, no value slicing). The `gpu` tests
run the compiled kernels on an NVIDIA card.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from magics_tpu.graph import tick as T
from magics_tpu.kernels.gbp_slot import SLOT_TOLERANCE, slot_mismatches
from magics_tpu.sim.builder import build_scenario, circle_formation


def _scenario(n_robots=6, **over):
    """A crossing with obstacles, tracking and a kinked route, so every
    factor kind sends real messages."""
    specs = circle_formation(n_robots, circle_radius=25.0, target_speed=10.0)
    for i, s in enumerate(specs):
        mid = 0.5 * (s.waypoints[0] + s.waypoints[1])
        mid[:2] += np.array([6.0, -4.0]) * (1 + i % 2)
        s.waypoints = np.stack([s.waypoints[0], mid, s.waypoints[1]])
    yy, xx = np.mgrid[0:64, 0:64]
    sdf = np.clip(np.hypot(xx - 40.0, yy - 24.0) / 12.0, 0.0, 1.0)
    kw = dict(
        target_speed=10.0, planning_horizon=3.0, hz=10.0, comms_radius=60.0,
        internal=6, external=3, n_slots=4, world=(100.0, 100.0), sdf=sdf,
        dtype=jnp.float32,
    )
    kw.update(over)
    return build_scenario(specs, **kw)


def _pre_gbp(state, params):
    state = T.activate_due_spawns(state)
    state = T.check_waypoints(state, params)
    state = T.update_connectivity(state, params)
    state = T.update_prior_horizon(state, params)
    return T.update_prior_current(state, params)


def _warm(params, state, sdf, ticks=3):
    """A few XLA ticks so inboxes, tracking records and the tracking skip
    counter are past their start-up values."""
    step = jax.jit(T.step, static_argnums=2)
    for _ in range(ticks):
        state = step(state, sdf, params)
    return _pre_gbp(state, params)


def _internal(state, sdf, params):
    state = T.internal_factor_pass(state, sdf, params)
    return T.internal_variable_pass(state, params)


def test_internal_slot_matches_xla():
    params, state, sdf = _scenario()
    st = _warm(params, state, sdf)
    pk = dataclasses.replace(params, use_pallas=True, pallas_interpret=True)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(_internal, static_argnums=2)(st, sdf, params)
        got = jax.jit(_internal, static_argnums=2)(st, sdf, pk)
    assert int(np.asarray(st.iter_count_factor).min()) >= 10  # tracking live
    assert float(np.abs(np.asarray(ref.trk_f2v_eta)).max()) > 0
    assert float(np.abs(np.asarray(ref.obs_f2v_eta)).max()) > 0
    assert slot_mismatches(ref, got) == []
    np.testing.assert_array_equal(
        np.asarray(ref.iter_count_factor), np.asarray(got.iter_count_factor)
    )
    np.testing.assert_array_equal(
        np.asarray(ref.ir_int_seeded), np.asarray(got.ir_int_seeded)
    )


def test_external_belief_pass_matches_xla():
    params, state, sdf = _scenario(comms_failure_rate=0.3)
    st = _warm(params, state, sdf)
    st = T.update_failed_comms(st, params)
    st = T.external_factor_pass(st, params)
    pk = dataclasses.replace(params, use_pallas=True, pallas_interpret=True)
    run = jax.jit(T.external_variable_pass, static_argnums=1)
    ref, got = run(st, params), run(st, pk)
    assert not bool(np.asarray(st.antenna).all())  # some robots gated off
    assert slot_mismatches(ref, got) == []
    # delivered responses are belief means: the means' tolerance
    a, b = np.asarray(ref.ir_v2f_ext_pos), np.asarray(got.ir_v2f_ext_pos)
    assert np.abs(a - b).max() <= 1e-2 * max(np.abs(a).max(), 1.0)


def test_slot_kernels_lower_for_cuda_at_headline_width():
    """R=1024, V=21, K=32 — the headline configuration. Lowering runs
    Pallas's Triton checks (power-of-two values, supported primitives)
    without a card."""
    specs = circle_formation(1024, circle_radius=800.0, target_speed=15.0)
    params, state, sdf = build_scenario(
        specs, target_speed=15.0, planning_horizon=5.0, hz=10.0,
        comms_radius=50.0, internal=1, external=1, n_slots=32,
        world=(2000.0, 2000.0), sdf=np.ones((128, 128)), dtype=jnp.float32,
        use_pallas=True,
    )
    assert params.n_vars == 21

    def slot(state, sdf):
        state = _internal(state, sdf, params)
        return T.external_variable_pass(state, params)

    text = jax.jit(slot).trace(state, sdf).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 3, text.count("triton")


@pytest.mark.slow
def test_multi_tick_trajectories_agree():
    """20 ticks of a 4-robot crossing: both paths drive the same
    trajectories. Knife-edge validity thresholds amplify roundoff once
    inter-robot factors engage, so meter-level agreement is the bar here;
    the single-slot tests pin the exact maths."""
    specs = circle_formation(4, circle_radius=22.0, target_speed=10.0)
    for i, s in enumerate(specs):
        shift = 1.0 + 0.15 * i
        s.start[:2] *= shift
        s.waypoints[0, :2] *= shift
    params, state, sdf = build_scenario(
        specs, target_speed=10.0, planning_horizon=3.0, hz=10.0,
        comms_radius=60.0, internal=6, external=3, n_slots=4,
        world=(100.0, 100.0), dtype=jnp.float32,
    )
    pp = dataclasses.replace(params, use_pallas=True, pallas_interpret=True)
    step = jax.jit(T.step, static_argnums=2)
    sx, sp_ = state, state
    for _ in range(20):
        sx = step(sx, sdf, params)
        sp_ = step(sp_, sdf, pp)
    px, ppos = np.asarray(sx.pos), np.asarray(sp_.pos)
    assert np.isfinite(ppos).all()
    assert np.abs(ppos - np.asarray(state.pos)).max() > 1.0
    assert np.abs(px - ppos).max() < 2.0, np.abs(px - ppos).max()


@pytest.mark.gpu
def test_compiled_slot_matches_xla_on_card(gpu_device):
    """The kernels as compiled for the card, one slot at R=1024."""
    specs = circle_formation(1024, circle_radius=800.0, target_speed=15.0)
    params, state, sdf = build_scenario(
        specs, target_speed=15.0, planning_horizon=5.0, hz=10.0,
        comms_radius=50.0, internal=6, external=3, n_slots=32,
        world=(2000.0, 2000.0), sdf=np.ones((128, 128)), dtype=jnp.float32,
    )
    state, sdf = jax.device_put((state, sdf), gpu_device)
    st = _warm(params, state, sdf)
    pk = dataclasses.replace(params, use_pallas=True)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(_internal, static_argnums=2)(st, sdf, params)
        got = jax.jit(_internal, static_argnums=2)(st, sdf, pk)
    assert slot_mismatches(ref, got) == []
    assert set(SLOT_TOLERANCE) >= {"belief_mean", "dyn_f2v_lam"}
