"""One simulation FixedUpdate tick, fully jitted.

Mirrors the reference's FixedUpdate system chain
(crates/magics/src/planner/robot.rs:86-108):

    reached_waypoint
    update_robot_neighbours  -> delete/create inter-robot factors
    update_failed_comms
    update_prior_of_horizon_state
    update_prior_of_current_state_v3
    iterate_gbp_v2  (schedule of internal/external GBP passes)

plus robot spawn activation and collision counting. Everything is dense and
masked — robot `active`/`mission` gates replace the reference's per-entity
queries, and inter-robot message routing becomes gathers over the neighbour
slot tables (cross-device these lower to XLA collectives under jit/shard_map).
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp

from magics_tpu.core.constants import DOFS, TRACKING_SKIP_FIRST_N_FACTOR_ITERS
from magics_tpu.graph import factors as F
from magics_tpu.graph import variables as VU
from magics_tpu.graph.state import GbpParams, SimState
from magics_tpu.parallel.comm import LOCAL


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _exp(mask: jax.Array, ndim_extra: int) -> jax.Array:
    """Expand a boolean mask with trailing singleton dims."""
    return mask.reshape(mask.shape + (1,) * ndim_extra)


def _where_rows(gate_r: jax.Array, new, old):
    """Per-robot select across a pytree of [R, ...] arrays."""
    return jax.tree_util.tree_map(
        lambda n, o: jnp.where(_exp(gate_r, n.ndim - 1), n, o), new, old
    )


def compute_back_slots(nbr_idx: jax.Array, nbr_mask: jax.Array, comm=LOCAL):
    """back[r, k] = slot k' on robot j = nbr_idx[r,k] with nbr_idx[j,k'] == r.

    Inter-robot connections are created symmetrically
    (robot.rs:1441-1586), so an active slot always has a reciprocal slot;
    `has_back` guards transient asymmetry (e.g. capacity overflow).
    Neighbour ids are *global* robot ids; under a sharded comm the peers'
    slot tables arrive via all_gather.
    """
    Rl, K = nbr_idx.shape
    nbr_all = comm.all_robots(nbr_idx)     # [R_total, K]
    R = nbr_all.shape[0]
    safe = jnp.clip(nbr_idx, 0, R - 1)
    their_rows = nbr_all[safe]             # [Rl, K, K]
    me = comm.row_ids(Rl).astype(nbr_idx.dtype)[:, None, None]
    eq = their_rows == me                  # [Rl, K, K]
    back = jnp.argmax(eq, axis=-1).astype(jnp.int32)
    has_back = jnp.any(eq, axis=-1) & nbr_mask
    return back, has_back



def _gather_from_peer(arr: jax.Array, nbr_idx, back, mask):
    """out[r, k, ...] = arr[nbr_idx[r,k], back[r,k], ...], 0 where ~mask.
    `arr` must be a GLOBAL [R_total, K, ...] array (comm.all_robots'd).

    Lowered as a single-axis row gather on the flattened [R*K, ...] table."""
    R = arr.shape[0]
    K = arr.shape[1]
    rest = arr.shape[2:]
    flat = arr.reshape(R * K, -1)
    idx = jnp.clip(nbr_idx, 0, R - 1) * K + jnp.clip(back, 0, K - 1)
    out = flat[idx.reshape(-1)].reshape(idx.shape + rest)
    return jnp.where(_exp(mask, out.ndim - 2), out, 0)


def _gather_robot(arr: jax.Array, nbr_idx, mask):
    """out[r, k, ...] = arr[nbr_idx[r,k], ...], 0 where ~mask.
    `arr` must be a GLOBAL [R_total, ...] array (comm.all_robots'd)."""
    R = arr.shape[0]
    safe = jnp.clip(nbr_idx, 0, R - 1)
    out = arr[safe]
    return jnp.where(_exp(mask, out.ndim - 2), out, 0)


# --------------------------------------------------------------------------
# spawn / waypoints / comms
# --------------------------------------------------------------------------

def activate_due_spawns(state: SimState) -> SimState:
    """Activate robots whose spawn tick has arrived (spawner.rs timers).

    Robots awaiting an in-flight global plan spawn Idle: active (they exist
    in the world) but not mission-active, so the GBP tick and prior updates
    skip them until mission.apply_plans delivers the path
    (MissionState::Idle, robot.rs:574-647)."""
    due = (
        (~state.active)
        & (~state.completed)
        & (state.spawn_tick >= 0)
        & (state.spawn_tick <= state.tick)
    )
    return replace(
        state,
        active=state.active | due,
        mission_active=state.mission_active | (due & ~state.plan_pending),
    )


def check_waypoints(state: SimState, params: GbpParams) -> SimState:
    """`reached_waypoint` (robot.rs:2080-2176) + despawn-on-finish."""
    R, V = state.prior_mean.shape[:2]
    gate = state.active & state.mission_active & ~state.completed
    has_next = state.target_idx < state.n_waypoints
    gate = gate & has_next

    is_last = state.target_idx == state.n_waypoints - 1
    check_var = jnp.where(is_last, state.fin_check_var, state.wp_check_var)
    check_d2 = jnp.where(is_last, state.fin_check_dist2, state.wp_check_dist2)

    est = jnp.take_along_axis(
        state.belief_mean[..., :2], jnp.clip(check_var, 0, V - 1)[:, None, None], axis=1
    )[:, 0]  # [R, 2]

    wp = jnp.take_along_axis(
        state.waypoints[..., :2],
        jnp.clip(state.target_idx, 0, state.waypoints.shape[1] - 1)[:, None, None],
        axis=1,
    )[:, 0]

    d2 = jnp.sum((est - wp) ** 2, axis=-1)
    reached = gate & (d2 < check_d2)

    new_target = jnp.where(reached, state.target_idx + 1, state.target_idx)
    newly_completed = reached & (new_target >= state.n_waypoints)
    completed = state.completed | newly_completed

    elapsed = state.tick.astype(state.finished_at.dtype) / params.hz
    finished_at = jnp.where(newly_completed, elapsed, state.finished_at)

    # tracking factors follow the new waypoint index (robot.rs:2157-2166)
    trk_index = jnp.where(reached & ~newly_completed, new_target, state.trk_index)

    active = state.active
    mission_active = state.mission_active & ~newly_completed
    if params.despawn_on_final_waypoint:
        active = active & ~newly_completed

    return replace(
        state,
            target_idx=new_target,
            completed=completed,
            finished_at=finished_at,
            trk_index=trk_index,
            active=active,
            mission_active=mission_active,
    )


def update_failed_comms(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Bernoulli antenna failure per robot per tick (robot.rs:1593-1601).

    The draw is always over the GLOBAL robot axis from the replicated key,
    each shard keeping its rows — so the failure pattern is bit-identical
    across shardings (SURVEY.md §7 hard part (e))."""
    if params.comms_failure_rate <= 0.0:
        return replace(state, antenna=jnp.ones_like(state.antenna))
    Rl = state.antenna.shape[0]
    R = Rl * getattr(comm, "n_shards", 1)
    key, sub = jax.random.split(state.rng)
    off = jax.random.bernoulli(sub, params.comms_failure_rate, shape=(R,))
    return replace(state, antenna=~comm.take_rows(off, Rl), rng=key)


# --------------------------------------------------------------------------
# connectivity (delete/create inter-robot factors)
# --------------------------------------------------------------------------

def update_connectivity(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Neighbour discovery + inter-robot factor lifecycle.

    Reference: update_robot_neighbours (O(N^2) range check,
    robot.rs:1362-1384), delete_interrobot_factors (robot.rs:1386-1439),
    create_interrobot_factors (robot.rs:1441-1586). Dense version: a masked
    fixed-capacity slot table per robot; dropped slots zero their message
    state; new slots seed the factor's external-variable inbox with the
    neighbour's current belief (the reference's initial message exchange,
    robot.rs:1547-1585).

    Pairwise matrices are [R_local, R_total]: local rows scan all robots'
    (gathered) positions — columns index global robot ids throughout.
    """
    Rl, K = state.nbr_idx.shape
    pos_all = comm.all_robots(state.pos)      # [R, 2]
    act_all = comm.all_robots(state.active)   # [R]
    R = act_all.shape[0]
    act = state.active
    me = comm.row_ids(Rl)                     # [Rl] global ids of local rows

    diff = state.pos[:, None, :] - pos_all[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)        # [Rl, R]
    radius2 = params.comms_radius * params.comms_radius
    cols = jnp.arange(R, dtype=jnp.int32)
    not_self = cols[None, :] != me[:, None]
    in_range = (d2 <= radius2) & not_self & act[:, None] & act_all[None, :]

    rows = jnp.arange(Rl)[:, None]

    # keep slots whose pair is still in range
    safe_idx = jnp.clip(state.nbr_idx, 0, R - 1)
    keep = state.nbr_mask & in_range[rows, safe_idx]

    # connected matrix from kept slots — compare-reduce, not scatter
    kept_ids = jnp.where(keep, state.nbr_idx, -1)
    conn = jnp.any(
        kept_ids[:, :, None] == cols[None, None, :],
        axis=1,
    )  # [Rl, R]

    new_pair = in_range & ~conn  # [Rl, R]

    # Assign new neighbours to free slots NEAREST-FIRST (ties by ascending
    # id — lax.top_k is stable). The reference connects every in-range pair
    # uncapped (robot.rs:1441-1586); with K >= in-range degree this fill is
    # exact (every new pair lands a slot on both ends, so reciprocity always
    # holds). When in-range > K the nearest-K truncation applies: distance
    # is symmetric, so mutual picks survive the reciprocity mask where the
    # old ascending-id fill collapsed to the lowest-id clique. Dropped
    # candidates are counted in nbr_overflow (never silent).
    # top_k + gather: slot assignment without a scatter of [R, R] updates.
    inf = jnp.asarray(jnp.inf, d2.dtype)
    key = jnp.where(new_pair, d2, inf)                    # [Rl, R]
    neg_d, cand_id = jax.lax.top_k(-key, min(K, R))       # K nearest new pairs
    cand_ok = neg_d > -inf
    free_rank = jnp.cumsum(~keep, axis=1) - 1             # [Rl, K]
    fr = jnp.clip(free_rank, 0, cand_id.shape[1] - 1)
    new_id = jnp.take_along_axis(cand_id, fr, axis=1).astype(jnp.int32)
    new_ok = jnp.take_along_axis(cand_ok, fr, axis=1)
    take = ~keep & (free_rank >= 0) & (free_rank < cand_id.shape[1]) & new_ok
    nbr_idx_new = jnp.where(take, new_id, -1)
    nbr_idx_new = jnp.where(keep, state.nbr_idx, nbr_idx_new)

    n_new = jnp.sum(new_pair, axis=1)
    n_free = jnp.sum(~keep, axis=1)
    dropped = comm.psum(jnp.sum(jnp.maximum(n_new - n_free, 0)))
    return _finish_connectivity(state, keep, nbr_idx_new, comm, dropped,
                                params=params)


def grid_candidates(state: SimState, params: GbpParams, comm=LOCAL):
    """Build the spatial grid from the (gathered) global positions and return
    each local robot's stencil candidates WITH their data:
    (cand_idx [Rl, M], cand_pos [Rl, M, 2], cand_rad [Rl, M], cand_mask).

    The search radius is the comms radius; when it also covers the largest
    possible colliding pair (comms_radius >= 2 * max_robot_radius — true for
    every shipped scenario), the same candidate table serves both neighbour
    discovery and collision detection, so the bucket build + stencil gather
    (the expensive part: an [Rl, stencil] row gather) happens once per tick.
    Candidate positions/radii ride in bucket-aligned tables
    (grid.build_grid_tables) — no per-candidate element gathers, which
    otherwise dominate the whole tick at swarm scale.
    """
    from magics_tpu.graph import grid as G

    Rl = state.pos.shape[0]
    pos_all = comm.all_robots(state.pos)      # [R, 2]
    act_all = comm.all_robots(state.active)   # [R]
    rad_all = comm.all_robots(state.radius)
    spec = G.make_grid_spec(
        (params.world_width, params.world_height),
        params.grid_cell_size,
        max(params.comms_radius, 2.0 * params.max_robot_radius),
        params.grid_capacity,
    )
    # the bucket tables are global (every shard builds them from the gathered
    # positions — one [R] sort, cheap and identical everywhere); candidate
    # lookups run on the local rows only
    bucket, bpos, brad = G.build_grid_tables(spec, pos_all, act_all, rad_all)
    cell_l = G.cell_ids(spec, state.pos, state.active)
    return G.candidate_data(
        spec, cell_l, bucket, bpos, brad, state.active, row_ids=comm.row_ids(Rl)
    )


def update_connectivity_grid(
    state: SimState, params: GbpParams, comm=LOCAL, candidates=None
) -> SimState:
    """Grid-accelerated connectivity (graph/grid.py): same semantics as
    `update_connectivity` — kept slots re-checked by exact distance, new
    in-range pairs assigned to free slots in ascending-id order — but the
    pair search runs over the stencil candidates instead of all R^2 pairs."""
    Rl, K = state.nbr_idx.shape
    pos_all = comm.all_robots(state.pos)      # [R, 2]
    act_all = comm.all_robots(state.active)   # [R]
    R = act_all.shape[0]
    cand_idx, cand_pos, _, cand_mask = (
        candidates if candidates is not None
        else grid_candidates(state, params, comm)
    )

    # account bucket-capacity drops in-state (once per tick, from the same
    # global positions the bucket build saw) — undersized grid_capacity must
    # never degrade connectivity silently (round-4 verdict item)
    from magics_tpu.graph import grid as G

    spec = G.make_grid_spec(
        (params.world_width, params.world_height),
        params.grid_cell_size,
        max(params.comms_radius, 2.0 * params.max_robot_radius),
        params.grid_capacity,
    )
    state = replace(
        state,
        grid_overflow=state.grid_overflow
        + G.grid_overflow(spec, pos_all, act_all).astype(jnp.int32),
    )
    radius2 = params.comms_radius * params.comms_radius

    # keep existing slots by exact distance (both endpoints alive)
    safe = jnp.clip(state.nbr_idx, 0, R - 1)
    d2_slot = jnp.sum((state.pos[:, None, :] - pos_all[safe]) ** 2, axis=-1)
    keep = (
        state.nbr_mask
        & state.active[:, None]
        & act_all[safe]
        & (d2_slot <= radius2)
    )

    # in-range candidates not already connected (cand_pos came with the
    # candidates — far away where masked, so the distance test also gates)
    d2 = jnp.sum((state.pos[:, None, :] - cand_pos) ** 2, axis=-1)
    in_range = cand_mask & (d2 <= radius2)
    kept_ids = jnp.where(keep, state.nbr_idx, -2)
    connected = jnp.any(cand_idx[:, :, None] == kept_ids[:, None, :], axis=-1)
    new_pair = in_range & ~connected

    # assign new neighbours to free slots nearest-first (see
    # update_connectivity — exact when K >= in-range degree, mutual-nearest
    # truncation with nbr_overflow accounting beyond that). lax.top_k of the
    # negated distance keys selects K of M ~ 300 candidates without a full
    # [R, M] sort or a scatter.
    inf = jnp.asarray(jnp.inf, d2.dtype)
    key = jnp.where(new_pair, d2, inf)
    M = key.shape[1]
    neg_d, sel = jax.lax.top_k(-key, min(K, M))              # [R, K] nearest
    sel_ids = jnp.take_along_axis(cand_idx, sel, axis=1).astype(jnp.int32)
    # canonicalise ties to (distance, id) lexicographic order: the dense
    # path's top_k over id-ordered columns breaks ties by ascending id, the
    # stencil's candidate order is bucket order — re-sort so both paths
    # assign identical slots (circle formations produce exact distance ties)
    sel_d2, sel_ids = jax.lax.sort(
        (-neg_d, sel_ids), num_keys=2, dimension=1
    )
    sel_ok = sel_d2 < inf
    free_rank = jnp.cumsum(~keep, axis=1) - 1                # [R, K]
    fr = jnp.clip(free_rank, 0, sel_ids.shape[1] - 1)
    new_id = jnp.take_along_axis(sel_ids, fr, axis=1).astype(jnp.int32)
    new_ok = jnp.take_along_axis(sel_ok, fr, axis=1)
    valid = ~keep & (free_rank >= 0) & (free_rank < M) & new_ok
    nbr_idx_new = jnp.where(valid, new_id, -1)
    nbr_idx_new = jnp.where(keep, state.nbr_idx, nbr_idx_new)

    n_new = jnp.sum(new_pair, axis=1)
    n_free = jnp.sum(~keep, axis=1)
    dropped = comm.psum(jnp.sum(jnp.maximum(n_new - n_free, 0)))
    return _finish_connectivity(state, keep, nbr_idx_new, comm, dropped,
                                params=params)


def _finish_connectivity(
    state: SimState, keep: jax.Array, nbr_idx_new: jax.Array, comm=LOCAL,
    dropped: jax.Array | None = None, params: GbpParams | None = None,
) -> SimState:
    """Shared connectivity tail: reciprocity enforcement, message-state reset
    for churned slots, and the new-factor belief seeding (robot.rs:1547-1585).

    `dropped` counts new in-range pairs that found no free slot this tick
    (the reference is uncapped, robot.rs:1441-1586 — nonzero means the K
    truncation is active and connectivity is a nearest-K approximation)."""
    is_new = ~keep & (nbr_idx_new >= 0)
    mask_new = keep | is_new

    # enforce reciprocity (both sides allocated a slot)
    back, has_back = compute_back_slots(nbr_idx_new, mask_new, comm)
    mask_new = mask_new & has_back
    is_new = is_new & mask_new

    # ---- message state maintenance ----
    slot_reset = ~keep  # covers dropped and newly-created slots

    def reset(arr):
        return jnp.where(_exp(slot_reset, arr.ndim - 2), 0, arr)

    ir_v2f_ext_pos = reset(state.ir_v2f_ext_pos)
    ir_f2v_ext = reset(state.ir_f2v_ext)
    ext_inbox = reset(state.ext_inbox)
    seeded = jnp.where(slot_reset[..., None], False, state.ir_int_seeded)

    # seed new factors' external linearisation point with the neighbour's
    # current belief mean (prepare_message of the nth variable,
    # robot.rs:1556-1566 — only the position enters the factor maths, see
    # state.py). Variables 1..V-1 of the neighbour map to chain slots 0..V-2.
    if params is not None and params.ext_exchange != "sender":
        # receiver-computes mirror: the PEER's new factor was seeded with
        # MY current belief position (churn is symmetric — both sides of a
        # pair reset the same tick), so the mirror write is local: no gather.
        own_pos = state.belief_mean[:, None, 1:, :2]
        ir_v2f_ext_pos = jnp.where(_exp(is_new, 2), own_pos, ir_v2f_ext_pos)
    else:
        nbr_belief_pos = _gather_robot(
            comm.all_robots(state.belief_mean[..., :2]), nbr_idx_new, is_new
        )[:, :, 1:, :]
        ir_v2f_ext_pos = jnp.where(_exp(is_new, 2), nbr_belief_pos, ir_v2f_ext_pos)

    # Cache the reciprocal-slot table for the rest of the tick. `back` was
    # computed on the PRE-reciprocity tables; on the final tables a slot's
    # reciprocal is alive iff the peer's slot survived its own mask (capacity
    # overflow can drop one side only). Connections are unique per (r, j)
    # pair, so the surviving reciprocal slot index is unchanged.
    K = nbr_idx_new.shape[1]
    mask_all = comm.all_robots(mask_new)  # [R_total, K]
    flat_mask = mask_all.reshape(-1)
    j_safe = jnp.clip(nbr_idx_new, 0, mask_all.shape[0] - 1)
    peer_alive = flat_mask[j_safe * K + jnp.clip(back, 0, K - 1)]
    has_back_final = mask_new & peer_alive

    return replace(
        state,
            nbr_idx=jnp.where(mask_new, nbr_idx_new, -1),
            nbr_mask=mask_new,
            nbr_back=back,
            nbr_has_back=has_back_final,
            ir_int_seeded=seeded,
            ir_v2f_ext_pos=ir_v2f_ext_pos,
            ir_f2v_ext=ir_f2v_ext,
            ext_inbox=ext_inbox,
            nbr_overflow=(
                state.nbr_overflow
                if dropped is None
                else state.nbr_overflow + dropped.astype(jnp.int32)
            ),
    )


# --------------------------------------------------------------------------
# prior updates
# --------------------------------------------------------------------------

def update_prior_horizon(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """`update_prior_of_horizon_state` (robot.rs:2182-2283).

    The horizon variable's prior mean is pulled towards the next waypoint at
    (at most) target speed; change_prior semantics: the variable's belief
    mean jumps to the new mean, its full belief (old eta/lam, new mean) is
    sent to every connected factor, and its own inbox is emptied
    (variable.rs:203-230).

    With a zero-internal schedule the reference skips the prior update for
    every robot (`if config.gbp.iteration_schedule.internal == 0 { continue }`,
    robot.rs:2231-2233) — the early return below reproduces that gate exactly
    (waypoint-exhaustion/despawn is handled separately in update_goals).
    """
    internal_iters = sum(1 for i, _ in params.schedule if i)
    if internal_iters == 0:
        return state

    R, V = state.prior_mean.shape[:2]
    f = state.prior_mean.dtype
    gate = (
        state.active
        & state.mission_active
        & ~state.completed
        & (state.target_idx < state.n_waypoints)
    )

    est_pos = state.belief_mean[:, V - 1, :2]
    wp = jnp.take_along_axis(
        state.waypoints[..., :2],
        jnp.clip(state.target_idx, 0, state.waypoints.shape[1] - 1)[:, None, None],
        axis=1,
    )[:, 0]
    h2w = wp - est_pos
    dist = jnp.linalg.norm(h2w, axis=-1, keepdims=True)
    direction = jnp.where(dist > 0, h2w / jnp.where(dist > 0, dist, 1.0), 0.0)
    new_vel = jnp.minimum(params.target_speed, dist) * direction
    new_pos = est_pos + new_vel * params.dt
    new_mean = jnp.concatenate([new_pos, new_vel], axis=-1).astype(f)  # [R, 4]

    g1 = _exp(gate, 1)

    prior_mean = state.prior_mean.at[:, V - 1].set(
        jnp.where(g1, new_mean, state.prior_mean[:, V - 1])
    )
    belief_mean = state.belief_mean.at[:, V - 1].set(
        jnp.where(g1, new_mean, state.belief_mean[:, V - 1])
    )

    # responses to connected factors: (old belief eta/lam, new mean)
    h_eta = state.belief_eta[:, V - 1]
    h_lam = state.belief_lam[:, V - 1]

    dyn_v2f_eta = state.dyn_v2f_eta.at[:, V - 2, 1].set(
        jnp.where(g1, h_eta, state.dyn_v2f_eta[:, V - 2, 1])
    )
    dyn_v2f_lam = state.dyn_v2f_lam.at[:, V - 2, 1].set(
        jnp.where(_exp(gate, 2), h_lam, state.dyn_v2f_lam[:, V - 2, 1])
    )
    dyn_v2f_mu = state.dyn_v2f_mu.at[:, V - 2, 1].set(
        jnp.where(g1, new_mean, state.dyn_v2f_mu[:, V - 2, 1])
    )

    snap_eta = state.snap_eta.at[:, V - 1].set(
        jnp.where(g1, h_eta, state.snap_eta[:, V - 1])
    )
    snap_lam = state.snap_lam.at[:, V - 1].set(
        jnp.where(_exp(gate, 2), h_lam, state.snap_lam[:, V - 1])
    )
    snap_mu = state.snap_mu.at[:, V - 1].set(
        jnp.where(g1, new_mean, state.snap_mu[:, V - 1])
    )
    if params.ext_exchange != "sender":
        # receiver-computes mirrors (state.py): the PEER's factor received MY
        # new horizon mean (ungated receive, robot.rs:2272-2282) — local
        # write gated on my change and the peer slot being alive; and the
        # PEER's seeded flag for its slot V-2 went true where ITS gate held.
        gate_all = comm.all_robots(gate)
        src = jnp.clip(state.nbr_idx, 0, gate_all.shape[0] - 1)
        seeded = state.ir_int_seeded.at[:, :, V - 2].set(
            jnp.where(
                gate_all[src] & state.nbr_has_back,
                True,
                state.ir_int_seeded[:, :, V - 2],
            )
        )
        ir_v2f_ext_pos = state.ir_v2f_ext_pos.at[:, :, V - 2].set(
            jnp.where(
                (gate[:, None] & state.nbr_has_back)[..., None],
                new_mean[:, None, :2],
                state.ir_v2f_ext_pos[:, :, V - 2],
            )
        )
    else:
        seeded = state.ir_int_seeded.at[:, :, V - 2].set(
            jnp.where(gate[:, None], state.nbr_mask, state.ir_int_seeded[:, :, V - 2])
        )

        # deliver responses to external factors (ungated receive,
        # robot.rs:2272-2282): the factor owned by (j, k) at chain slot V-2
        # has r = nbr_idx[j, k]'s horizon variable as its external variable.
        # Only the response's mean position enters the factor maths (state.py).
        gate_all = comm.all_robots(gate)                    # [R_total]
        new_mean_all = comm.all_robots(new_mean)            # [R_total, 4]
        src = jnp.clip(state.nbr_idx, 0, gate_all.shape[0] - 1)  # j's nbr r
        sent = gate_all[src] & state.nbr_mask    # r actually changed its prior
        ir_v2f_ext_pos = state.ir_v2f_ext_pos.at[:, :, V - 2].set(
            jnp.where(
                _exp(sent, 1), new_mean_all[src][..., :2],
                state.ir_v2f_ext_pos[:, :, V - 2],
            )
        )

    # empty the horizon variable's inbox
    dyn_f2v_eta = state.dyn_f2v_eta.at[:, V - 2, 1].set(
        jnp.where(g1, 0.0, state.dyn_f2v_eta[:, V - 2, 1])
    )
    dyn_f2v_lam = state.dyn_f2v_lam.at[:, V - 2, 1].set(
        jnp.where(_exp(gate, 2), 0.0, state.dyn_f2v_lam[:, V - 2, 1])
    )
    ext_inbox = state.ext_inbox.at[:, :, V - 2].set(
        jnp.where(_exp(gate, 2), 0.0, state.ext_inbox[:, :, V - 2])
    )

    return replace(
        state,
            prior_mean=prior_mean,
            belief_mean=belief_mean,
            dyn_v2f_eta=dyn_v2f_eta,
            dyn_v2f_lam=dyn_v2f_lam,
            dyn_v2f_mu=dyn_v2f_mu,
            snap_eta=snap_eta,
            snap_lam=snap_lam,
            snap_mu=snap_mu,
            ir_int_seeded=seeded,
            ir_v2f_ext_pos=ir_v2f_ext_pos,
            dyn_f2v_eta=dyn_f2v_eta,
            dyn_f2v_lam=dyn_f2v_lam,
            ext_inbox=ext_inbox,
    )


def update_prior_current(state: SimState, params: GbpParams) -> SimState:
    """`update_prior_of_current_state_v3` (robot.rs:2286-2338).

    The current variable's mean advances towards variable 1 by
    dt / t0, and the robot's world transform moves by the same amount.
    """
    R, V = state.prior_mean.shape[:2]
    # reference gate: only Idle missions skip (robot.rs:2305) — Completed
    # robots that have not despawned keep driving towards variable 1.
    gate = state.active & (state.mission_active | state.completed)
    g1 = _exp(gate, 1)

    time_scale = (params.dt / state.t0)[:, None]  # [R, 1]
    change = time_scale * (state.belief_mean[:, 1] - state.belief_mean[:, 0])
    new_mean = state.belief_mean[:, 0] + change

    prior_mean = state.prior_mean.at[:, 0].set(
        jnp.where(g1, new_mean, state.prior_mean[:, 0])
    )
    belief_mean = state.belief_mean.at[:, 0].set(
        jnp.where(g1, new_mean, state.belief_mean[:, 0])
    )

    c_eta = state.belief_eta[:, 0]
    c_lam = state.belief_lam[:, 0]

    dyn_v2f_eta = state.dyn_v2f_eta.at[:, 0, 0].set(
        jnp.where(g1, c_eta, state.dyn_v2f_eta[:, 0, 0])
    )
    dyn_v2f_lam = state.dyn_v2f_lam.at[:, 0, 0].set(
        jnp.where(_exp(gate, 2), c_lam, state.dyn_v2f_lam[:, 0, 0])
    )
    dyn_v2f_mu = state.dyn_v2f_mu.at[:, 0, 0].set(
        jnp.where(g1, new_mean, state.dyn_v2f_mu[:, 0, 0])
    )
    snap_eta = state.snap_eta.at[:, 0].set(jnp.where(g1, c_eta, state.snap_eta[:, 0]))
    snap_lam = state.snap_lam.at[:, 0].set(
        jnp.where(_exp(gate, 2), c_lam, state.snap_lam[:, 0])
    )
    snap_mu = state.snap_mu.at[:, 0].set(jnp.where(g1, new_mean, state.snap_mu[:, 0]))

    dyn_f2v_eta = state.dyn_f2v_eta.at[:, 0, 0].set(
        jnp.where(g1, 0.0, state.dyn_f2v_eta[:, 0, 0])
    )
    dyn_f2v_lam = state.dyn_f2v_lam.at[:, 0, 0].set(
        jnp.where(_exp(gate, 2), 0.0, state.dyn_f2v_lam[:, 0, 0])
    )

    pos = jnp.where(g1, state.pos + change[:, :2], state.pos)

    return replace(
        state,
            prior_mean=prior_mean,
            belief_mean=belief_mean,
            dyn_v2f_eta=dyn_v2f_eta,
            dyn_v2f_lam=dyn_v2f_lam,
            dyn_v2f_mu=dyn_v2f_mu,
            snap_eta=snap_eta,
            snap_lam=snap_lam,
            snap_mu=snap_mu,
            dyn_f2v_eta=dyn_f2v_eta,
            dyn_f2v_lam=dyn_f2v_lam,
            pos=pos,
    )


# --------------------------------------------------------------------------
# GBP passes
# --------------------------------------------------------------------------

def _not_idle(state: SimState) -> jax.Array:
    # MissionState is Idle only for global planning before a path arrives;
    # Active and Completed both iterate (robot.rs:1795).
    return state.mission_active | state.completed


def internal_factor_pass(state: SimState, sdf: jax.Array, params: GbpParams) -> SimState:
    """All non-interrobot factors update (factorgraph.rs:686-714)."""
    R, V = state.prior_mean.shape[:2]
    gate = state.active & _not_idle(state)
    g2 = _exp(gate, 2)
    g3 = _exp(gate, 3)
    # factorgraph.rs:701 — skip tracking for the first 10 factor passes
    t_gate = gate & (state.iter_count_factor >= TRACKING_SKIP_FIRST_N_FACTOR_ITERS)
    iter_count = state.iter_count_factor + gate.astype(jnp.int32)

    if params.use_pallas:
        from magics_tpu.kernels.gbp_slot import factor_pass

        updates = factor_pass(
            state, sdf, params, gate, t_gate, interpret=params.pallas_interpret
        )
        return replace(state, iter_count_factor=iter_count, **updates)

    updates: dict = {}

    if params.dynamic_enabled:
        ts = jnp.asarray(params.variable_timesteps, dtype=state.t0.dtype)
        dt_gaps = ts[1:] - ts[:-1]  # [V-1]
        delta_t = state.t0[:, None] * dt_gaps[None, :]  # [R, V-1]
        f2v_eta, f2v_lam = F.dynamic_factor_messages(
            state.dyn_v2f_eta,
            state.dyn_v2f_lam,
            state.dyn_v2f_mu,
            delta_t,
            params.sigma_factor_dynamics,
            dtype=state.prior_mean.dtype,
        )
        updates["dyn_f2v_eta"] = jnp.where(_exp(gate, 3), f2v_eta, state.dyn_f2v_eta)
        updates["dyn_f2v_lam"] = jnp.where(_exp(gate, 4), f2v_lam, state.dyn_f2v_lam)

    if params.obstacle_enabled and V > 2:
        o_eta, o_lam = F.obstacle_factor_messages(
            state.obs_v2f_mu,
            sdf,
            (params.world_width, params.world_height),
            params.sigma_factor_obstacle,
            dtype=state.prior_mean.dtype,
        )
        updates["obs_f2v_eta"] = jnp.where(g2, o_eta, state.obs_f2v_eta)
        updates["obs_f2v_lam"] = jnp.where(g3, o_lam, state.obs_f2v_lam)

    if params.tracking_enabled and V > 2:
        t2 = _exp(t_gate, 2)
        (
            t_eta,
            t_lam,
            new_record,
            new_timeout,
            last_pos,
            last_val,
            skipped,
        ) = F.tracking_factor_messages(
            state.trk_v2f_mu,
            state.trk_path,
            state.trk_path_len,
            state.trk_record,
            state.trk_index,
            state.trk_timeout,
            params.tracking_switch_padding,
            params.tracking_attraction_distance,
            params.sigma_factor_tracking,
            dtype=state.prior_mean.dtype,
        )
        measured = _exp(t_gate, 1) & ~skipped
        updates["trk_f2v_eta"] = jnp.where(t2, t_eta, state.trk_f2v_eta)
        updates["trk_f2v_lam"] = jnp.where(_exp(t_gate, 3), t_lam, state.trk_f2v_lam)
        updates["trk_record"] = jnp.where(_exp(t_gate, 1), new_record, state.trk_record)
        updates["trk_timeout"] = jnp.where(
            _exp(t_gate, 1), new_timeout, state.trk_timeout
        )
        updates["trk_last_pos"] = jnp.where(
            measured[..., None], last_pos, state.trk_last_pos
        )
        updates["trk_last_val"] = jnp.where(measured, last_val, state.trk_last_val)

    updates["iter_count_factor"] = iter_count
    return replace(state, **updates)


def internal_variable_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Belief update + responses to internal factors (factorgraph.rs:762-790)."""
    R, V = state.prior_mean.shape[:2]
    gate = state.active & _not_idle(state)
    g2, g3 = _exp(gate, 2), _exp(gate, 3)
    if params.use_pallas:
        from magics_tpu.kernels.gbp_slot import belief_pass

        updates = belief_pass(
            state, params, gate, responses=True,
            interpret=params.pallas_interpret,
        )
        return _seed_interrobot(replace(state, **updates), params, gate, comm)

    eta, lam = VU.sum_messages(
        prior_mean=state.prior_mean,
        prior_sigma=state.prior_sigma,
        dyn_f2v_eta=state.dyn_f2v_eta,
        dyn_f2v_lam=state.dyn_f2v_lam,
        obs_f2v_eta=state.obs_f2v_eta,
        obs_f2v_lam=state.obs_f2v_lam,
        trk_f2v_eta=state.trk_f2v_eta,
        trk_f2v_lam=state.trk_f2v_lam,
        ext_inbox=state.ext_inbox,
    )
    upd = VU.update_beliefs(eta, lam, state.belief_mean)

    belief_eta = jnp.where(g2, upd.eta, state.belief_eta)
    belief_lam = jnp.where(g3, upd.lam, state.belief_lam)
    belief_mean = jnp.where(g2, upd.mean, state.belief_mean)

    # responses = belief - incoming message per edge; mu = belief mean
    updates: dict = {
        "belief_eta": belief_eta,
        "belief_lam": belief_lam,
        "belief_mean": belief_mean,
    }

    if params.dynamic_enabled:
        # dyn edge e: slot 0 <- var e, slot 1 <- var e+1
        v_eta = jnp.stack([belief_eta[:, :-1], belief_eta[:, 1:]], axis=2)
        v_lam = jnp.stack([belief_lam[:, :-1], belief_lam[:, 1:]], axis=2)
        v_mu = jnp.stack([belief_mean[:, :-1], belief_mean[:, 1:]], axis=2)
        updates["dyn_v2f_eta"] = jnp.where(
            g3, v_eta - state.dyn_f2v_eta, state.dyn_v2f_eta
        )
        updates["dyn_v2f_lam"] = jnp.where(
            _exp(gate, 4), v_lam - state.dyn_f2v_lam, state.dyn_v2f_lam
        )
        updates["dyn_v2f_mu"] = jnp.where(g3, v_mu, state.dyn_v2f_mu)

    if V > 2:
        if params.obstacle_enabled:
            updates["obs_v2f_mu"] = jnp.where(
                g2, belief_mean[:, 1 : V - 1], state.obs_v2f_mu
            )
        if params.tracking_enabled:
            updates["trk_v2f_mu"] = jnp.where(
                g2, belief_mean[:, 1 : V - 1], state.trk_v2f_mu
            )

    # snapshot for own inter-robot factors (response to an always-empty inbox
    # entry is the full belief)
    updates["snap_eta"] = jnp.where(g2, belief_eta, state.snap_eta)
    updates["snap_lam"] = jnp.where(g3, belief_lam, state.snap_lam)
    updates["snap_mu"] = jnp.where(g2, belief_mean, state.snap_mu)
    return _seed_interrobot(replace(state, **updates), params, gate, comm)


def _seed_interrobot(
    state: SimState, params: GbpParams, gate: jax.Array, comm=LOCAL
) -> SimState:
    """The internal variable pass's response to the robot's own inter-robot
    factors seeds their internal inbox (ir_int_seeded)."""
    if not params.interrobot_enabled:
        return state
    if params.ext_exchange != "sender":
        # receiver-computes mirror of the PEER's seeded flag: the peer's
        # cavity for its reciprocal slot went live where ITS internal
        # gate held and its slot is alive (state.py mirror semantics)
        gate_all = comm.all_robots(gate)
        src = jnp.clip(state.nbr_idx, 0, gate_all.shape[0] - 1)
        seeded = jnp.where(
            (gate_all[src] & state.nbr_has_back)[..., None],
            True,
            state.ir_int_seeded,
        )
    else:
        seeded = jnp.where(
            gate[:, None, None] & state.nbr_mask[..., None], True,
            state.ir_int_seeded,
        )
    return replace(state, ir_int_seeded=seeded)


def _external_factor_pass_receiver(
    state: SimState, params: GbpParams, comm=LOCAL
) -> SimState:
    """Receiver-computes inter-robot exchange (ARCHITECTURE §8 lever (a)).

    Instead of gathering the peers' outboxes by (peer, reciprocal-slot) —
    the [R, K, V-1, 4] per-slot gather that dominates swarm-scale ticks —
    each receiver recomputes the incoming message locally from

      * the peer's snapshot tables, gathered as plain [R, K]-rows-from-
        [R, D] (the cheap pattern), or their compact [R, V-1, 8] cavity
        form ("receiver_compact", factors.interrobot_rank1_messages_compact),
      * the mirror of its OWN positions as held by the peer
        (ir_v2f_ext_pos under receiver semantics — purely local), and
      * slot-deterministic tiny offsets + the peer's radius/gate bits.

    "receiver" uses the identical arithmetic as the sender path (bit-equal
    inboxes, asserted in tests/test_receiver_ext.py); "receiver_compact" is
    the Sherman-Morrison rearrangement (equivalent to roundoff).
    """
    R, K = state.nbr_idx.shape
    V = state.prior_mean.shape[1]
    V1 = V - 1
    f = state.prior_mean.dtype

    send_gate = state.active & state.antenna & _not_idle(state)  # [R]
    gate_all = comm.all_robots(send_gate)
    src = jnp.clip(state.nbr_idx, 0, gate_all.shape[0] - 1)
    # the peer's factor produced this pass AND I receive it — symmetric in
    # (r, j) exactly like the sender path's produced & deliver chain
    deliver = (
        _exp(send_gate, 1) & state.nbr_mask & gate_all[src] & state.nbr_has_back
    )  # [R, K]

    gids_j = src.astype(f)
    back = state.nbr_back.astype(f)
    iota_v = jnp.arange(V1, dtype=f)
    tiny = jnp.asarray(1e-6, f) * (
        gids_j[..., None] * (K * V1) + back[..., None] * V1 + iota_v + 1.0
    )  # [R, K, V1]

    rad_all = comm.all_robots(state.radius)
    safety = jnp.broadcast_to(
        (params.safety_distance_multiplier * rad_all[src])[..., None], (R, K, V1)
    )

    seeded = state.ir_int_seeded      # mirror: peer's cavity present
    p_ext = state.ir_v2f_ext_pos      # mirror: my position as held by peer

    if params.ext_exchange == "receiver_compact":
        tables = F.compact_snap_tables(
            state.snap_mu, state.snap_eta, state.snap_lam, dtype=f
        )  # [R, V1, 8]
        tables_all = comm.all_robots(tables).reshape(-1, V1 * 8)
        peer_tab = tables_all[src].reshape(R, K, V1, 8)
        msg = F.interrobot_rank1_messages_compact(
            peer_tab, seeded, p_ext, safety, tiny,
            params.sigma_factor_interrobot, dtype=f,
        )
    else:
        pack = jnp.concatenate(
            [
                state.snap_mu[:, 1:],
                state.snap_eta[:, 1:],
                state.snap_lam[:, 1:].reshape(R, V1, 16),
            ],
            axis=-1,
        )  # [R, V1, 24]
        pack_all = comm.all_robots(pack).reshape(-1, V1 * 24)
        peer = pack_all[src].reshape(R, K, V1, 24)
        s3 = seeded[..., None]
        x_int = jnp.where(s3, peer[..., 0:4], 0.0)
        cav_eta = jnp.where(s3, peer[..., 4:8], 0.0)
        cav_lam = jnp.where(
            s3[..., None], peer[..., 8:24].reshape(R, K, V1, 4, 4), 0.0
        )
        msg = F.interrobot_rank1_messages(
            x_int, p_ext, cav_eta, cav_lam, safety, tiny,
            params.sigma_factor_interrobot, dtype=f,
        )

    ext_inbox = jnp.where(deliver[..., None, None], msg, state.ext_inbox)
    iter_count = state.iter_count_factor + send_gate.astype(jnp.int32)
    return replace(state, ext_inbox=ext_inbox, iter_count_factor=iter_count)


def external_factor_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Inter-robot factor update + message delivery (factorgraph.rs:719-760,
    routing robot.rs:1803-1831). Messages are compact rank-1 (state.py).

    With params.ext_exchange in ("receiver", "receiver_compact") the
    exchange is receiver-computes instead (no outbox, no per-slot gather)."""
    if not params.interrobot_enabled:
        return state
    if params.ext_exchange != "sender":
        return _external_factor_pass_receiver(state, params, comm)

    R, K = state.nbr_idx.shape
    V = state.prior_mean.shape[1]
    V1 = V - 1
    f = state.prior_mean.dtype
    gids = comm.row_ids(R).astype(f)  # global robot ids of local rows

    send_gate = state.active & state.antenna & _not_idle(state)  # [R]

    # linearisation inputs; the internal cavity is the belief snapshot
    # where the variable has ever responded (empty message = zeros else)
    seeded = state.ir_int_seeded  # [R, K, V-1]
    own_mu = state.snap_mu[:, None, 1:, :]  # [R, 1, V-1, 4]
    own_eta = state.snap_eta[:, None, 1:, :]
    own_lam = state.snap_lam[:, None, 1:, :, :]
    s3 = seeded[..., None]
    x_int = jnp.where(s3, own_mu, 0.0)
    cav_eta = jnp.where(s3, own_eta, 0.0)
    cav_lam = jnp.where(s3[..., None], own_lam, 0.0)

    safety = (params.safety_distance_multiplier * state.radius)[:, None, None]
    safety = jnp.broadcast_to(safety, (R, K, V1))
    # Per-factor tiny offset (interrobot.rs:75,91-106). The reference
    # derives it from a global factor-creation counter; besides guarding
    # div/0 the *distinctness* of the offsets breaks symmetric head-on
    # deadlocks, so we keep per-factor-distinct values — but
    # slot-deterministic instead of creation-order-dependent, so results
    # are reproducible across shardings.
    tiny = jnp.asarray(1e-6, f) * (
        gids[:, None, None] * (K * V1)
        + jnp.arange(K, dtype=f)[None, :, None] * V1
        + jnp.arange(V1, dtype=f)[None, None, :]
        + 1.0
    )

    msg = F.interrobot_rank1_messages(
        x_int,
        state.ir_v2f_ext_pos,
        cav_eta,
        cav_lam,
        safety,
        tiny,
        params.sigma_factor_interrobot,
        dtype=f,
    )  # [R, K, V-1, 4]

    produced = _exp(send_gate, 2) & state.nbr_mask[..., None]  # [R, K, V-1]
    ir_f2v_ext = jnp.where(produced[..., None], msg, state.ir_f2v_ext)

    # delivery: r's variable inbox slot (r, k, i) receives from the factor
    # owned by j = nbr_idx[r,k] at its reciprocal slot. Gated on the sender
    # having produced this pass and the receiver's antenna/mission. Under a
    # sharded comm the peers' outboxes and send gates arrive via all_gather —
    # the inter-robot message exchange between devices (SURVEY.md §2.4).
    back, has_back = state.nbr_back, state.nbr_has_back
    recv_gate = state.active & state.antenna & _not_idle(state)
    send_gate_all = comm.all_robots(send_gate)
    src = jnp.clip(state.nbr_idx, 0, send_gate_all.shape[0] - 1)
    deliver = (
        _exp(recv_gate, 1) & state.nbr_mask & send_gate_all[src] & has_back
    )[..., None]  # [R, K, 1] broadcast over V-1

    in_msg = _gather_from_peer(
        comm.all_robots(ir_f2v_ext), state.nbr_idx, back, state.nbr_mask
    )
    ext_inbox = jnp.where(deliver[..., None], in_msg, state.ext_inbox)

    iter_count = state.iter_count_factor + send_gate.astype(jnp.int32)

    return replace(
        state,
            ir_f2v_ext=ir_f2v_ext,
            ext_inbox=ext_inbox,
            iter_count_factor=iter_count,
    )


def external_variable_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Belief update + responses to external factors (factorgraph.rs:794-826,
    routing robot.rs:1843-1858).

    The response to an external factor is belief − incoming message; of it
    the factor only ever uses the mean position (the response eta/lam enter
    only the factor's dropped internal-edge message, state.py), so delivery
    reduces to a gather of the peer's belief mean positions.
    """
    if not params.interrobot_enabled:
        return state

    R, K = state.nbr_idx.shape
    V = state.prior_mean.shape[1]
    gate = state.active & state.antenna & _not_idle(state)
    g2, g3 = _exp(gate, 2), _exp(gate, 3)

    if params.use_pallas:
        from magics_tpu.kernels.gbp_slot import belief_pass

        beliefs = belief_pass(
            state, params, gate, responses=False,
            interpret=params.pallas_interpret,
        )
        belief_eta = beliefs["belief_eta"]
        belief_lam = beliefs["belief_lam"]
        belief_mean = beliefs["belief_mean"]
    else:
        eta, lam = VU.sum_messages(
            prior_mean=state.prior_mean,
            prior_sigma=state.prior_sigma,
            dyn_f2v_eta=state.dyn_f2v_eta,
            dyn_f2v_lam=state.dyn_f2v_lam,
            obs_f2v_eta=state.obs_f2v_eta,
            obs_f2v_lam=state.obs_f2v_lam,
            trk_f2v_eta=state.trk_f2v_eta,
            trk_f2v_lam=state.trk_f2v_lam,
            ext_inbox=state.ext_inbox,
        )
        upd = VU.update_beliefs(eta, lam, state.belief_mean)
        belief_eta = jnp.where(g2, upd.eta, state.belief_eta)
        belief_lam = jnp.where(g3, upd.lam, state.belief_lam)
        belief_mean = jnp.where(g2, upd.mean, state.belief_mean)

    # deliver into the owning factor's inbox: factor (r, k) receives the
    # response computed by j = nbr_idx[r,k] — the same belief mean for every
    # reciprocal slot, so a per-robot gather suffices (has_back still gates:
    # the peer only responds on edges it has a slot for).
    has_back = state.nbr_has_back
    gate_all = comm.all_robots(gate)
    src = jnp.clip(state.nbr_idx, 0, gate_all.shape[0] - 1)
    deliver = (
        _exp(gate, 1)        # receiver (factor owner) gate
        & state.nbr_mask
        & gate_all[src]      # sender produced this pass
        & has_back
    )[..., None]

    if params.ext_exchange != "sender":
        # receiver-computes mirror: the PEER's factor inbox entry for MY
        # variables updated with MY new belief — the delivery condition is
        # symmetric in (r, j) (gate[r] & gate[j] & both slots alive), so the
        # same `deliver` mask gates the local mirror write. No gather.
        ir_v2f_ext_pos = jnp.where(
            deliver[..., None], belief_mean[:, None, 1:, :2],
            state.ir_v2f_ext_pos,
        )
    else:
        in_pos = _gather_robot(
            comm.all_robots(belief_mean[:, 1:, :2]), state.nbr_idx, state.nbr_mask
        )
        ir_v2f_ext_pos = jnp.where(
            deliver[..., None], in_pos, state.ir_v2f_ext_pos
        )

    return replace(
        state,
            belief_eta=belief_eta,
            belief_lam=belief_lam,
            belief_mean=belief_mean,
            ir_v2f_ext_pos=ir_v2f_ext_pos,
    )


def iterate_gbp(state: SimState, sdf: jax.Array, params: GbpParams, comm=LOCAL) -> SimState:
    """`iterate_gbp_v2` (robot.rs:1769-1861): run the iteration schedule.

    The schedule flags are static, so the loop unrolls at trace time: no
    `lax.cond` (whose identity branches force whole-state copies every slot)
    and no scan carry — XLA sees the straight-line dataflow of exactly the
    passes that run and fuses/aliases across slots.
    """
    if not params.schedule:
        return state

    def slot(state, internal_flag, external_flag):
        if internal_flag:
            state = internal_factor_pass(state, sdf, params)
            state = internal_variable_pass(state, params, comm)
        if external_flag:
            state = external_factor_pass(state, params, comm)
            state = external_variable_pass(state, params, comm)
        return state

    if params.scan_schedule:
        # Compress contiguous identical-flag runs into one lax.scan each:
        # HLO size becomes O(#distinct runs) instead of O(schedule length),
        # trading some runtime (the scan carry forces whole-state copies at
        # run boundaries) for bounded compile times on long schedules.
        runs: list[list] = []
        for flags in params.schedule:
            if runs and runs[-1][0] == flags:
                runs[-1][1] += 1
            else:
                runs.append([flags, 1])
        for (i_flag, e_flag), n in runs:
            if not (i_flag or e_flag):
                continue
            if n == 1:
                state = slot(state, i_flag, e_flag)
            else:
                state, _ = jax.lax.scan(
                    lambda st, _: (slot(st, i_flag, e_flag), None),
                    state, None, length=n,
                )
        return state

    for internal_flag, external_flag in params.schedule:
        state = slot(state, internal_flag, external_flag)
    return state


def update_message_counts(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Per-robot message counters (factorgraph/mod.rs:28-125, summed per
    graph factorgraph.rs:874-890): internal/external x sent/received.

    All gating masks (active/mission, antenna, neighbour slots) are constant
    within a tick — antenna flips once per tick in update_failed_comms — so
    the per-slot counts reduce to closed-form products accumulated once per
    tick. Skipped factors still *send* empty messages (factor/mod.rs:352-369)
    and are counted, exactly like the reference's receive_message_from calls.

    msg_counts layout: [R, 4] = (internal sent, external sent,
    internal received, external received).
    """
    R, V = state.prior_mean.shape[:2]
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e)
    if n_int == 0 and n_ext == 0:
        return state

    gate = (state.active & _not_idle(state)).astype(jnp.int32)
    k_active = jnp.sum(state.nbr_mask, axis=1).astype(jnp.int32)  # [R]

    # --- internal slot (factor pass + variable pass), per slot ---
    per_factor_msgs = 0
    if params.dynamic_enabled:
        per_factor_msgs += 2 * (V - 1)
    if params.obstacle_enabled and V > 2:
        per_factor_msgs += V - 2
    if params.tracking_enabled and V > 2:
        per_factor_msgs += V - 2
    # variable responses mirror the factor edges, plus one response per own
    # inter-robot factor edge (the belief snapshot push)
    int_per_slot = gate * (2 * per_factor_msgs) + gate * k_active * (V - 1)
    internal = n_int * int_per_slot  # sent == received (same graph)

    # --- external slot ---
    send_gate = (state.active & state.antenna & _not_idle(state)).astype(jnp.int32)
    ext_sent = jnp.zeros((R,), jnp.int32)
    ext_recv = jnp.zeros((R,), jnp.int32)
    if params.interrobot_enabled and n_ext > 0:
        has_back = state.nbr_has_back
        send_gate_all = comm.all_robots(send_gate)
        src = jnp.clip(state.nbr_idx, 0, send_gate_all.shape[0] - 1)
        # factor pass: each of r's ir factors sends (V-1) messages to the
        # external variable; delivery gated on receiver antenna/mission
        produced = send_gate[:, None] * state.nbr_mask.astype(jnp.int32)
        deliver = (
            (send_gate[:, None] > 0)
            & state.nbr_mask
            & (send_gate_all[src] > 0)
            & has_back
        ).astype(jnp.int32)
        # explicit int32: under x64 jnp.sum promotes int32 to int64, which
        # would change the scan carry dtype of msg_counts
        n_prod = jnp.sum(produced, axis=1).astype(jnp.int32)
        n_del = jnp.sum(deliver, axis=1).astype(jnp.int32)
        ext_sent += n_prod * (V - 1)
        ext_recv += n_del * (V - 1)
        # variable pass: responses to external factors, same masks mirrored
        ext_sent += n_del * (V - 1)
        ext_recv += n_del * (V - 1)
        ext_sent = n_ext * ext_sent
        ext_recv = n_ext * ext_recv

    counts = jnp.stack([internal, ext_sent, internal, ext_recv], axis=1)
    return replace(state, msg_counts=state.msg_counts + counts)


# --------------------------------------------------------------------------
# collisions
# --------------------------------------------------------------------------

def update_collisions(
    state: SimState, params: GbpParams, env_dist: jax.Array | None = None,
    comm=LOCAL,
) -> SimState:
    """Robot-robot (bounding spheres) and robot-environment collision events
    with hysteresis (collisions.rs:72-140,146-227). `env_dist` is the
    euclidean distance field (meters to nearest obstacle pixel).

    The pairwise matrices are [R_local, R_total] (rows local, columns global);
    the global event count is a psum and the per-column partner counts come
    back via reduce-scatter."""
    Rl = state.pos.shape[0]
    pos_all = comm.all_robots(state.pos)
    rad_all = comm.all_robots(state.radius)
    act_all = comm.all_robots(state.active)
    R = act_all.shape[0]
    me = comm.row_ids(Rl)
    cols = jnp.arange(R, dtype=jnp.int32)

    diff = state.pos[:, None, :] - pos_all[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    rsum = state.radius[:, None] + rad_all[None, :]
    act = state.active
    upper = cols[None, :] > me[:, None]
    pair_overlap = (d2 < rsum * rsum) & upper & act[:, None] & act_all[None, :]
    new_pair = pair_overlap & ~state.rr_overlap
    new_events = comm.psum(jnp.sum(new_pair))
    rr_count = (
        state.rr_count
        + jnp.sum(new_pair, axis=1).astype(jnp.int32)
        + comm.scatter_rows(jnp.sum(new_pair, axis=0)).astype(jnp.int32)
    )

    updates = dict(
        rr_overlap=pair_overlap,
        rr_collisions=state.rr_collisions + new_events.astype(jnp.int32),
        rr_count=rr_count,
    )

    # event AABB recording (export.rs:171-185): intersection box of the two
    # robots' disc AABBs, appended to a ring buffer. Experiment-scale only —
    # the ring-buffer write order is global, so it stays single-shard.
    C = state.rr_events.shape[0]
    if C > 0 and getattr(comm, "n_shards", 1) > 1:
        raise NotImplementedError(
            "collision event AABB recording is single-shard only "
            "(set collision_log_capacity=0 for sharded runs)"
        )
    if C > 0:
        f = state.pos.dtype
        flat = new_pair.reshape(-1)  # [R*R]
        ii = jnp.arange(R)
        a_idx = jnp.broadcast_to(ii[:, None], (R, R)).reshape(-1)
        b_idx = jnp.broadcast_to(ii[None, :], (R, R)).reshape(-1)
        pa, ra = state.pos[a_idx], state.radius[a_idx]
        pb, rb = state.pos[b_idx], state.radius[b_idx]
        mn = jnp.maximum(pa - ra[:, None], pb - rb[:, None])
        mx = jnp.minimum(pa + ra[:, None], pb + rb[:, None])
        rows = jnp.concatenate(
            [
                a_idx[:, None].astype(f),
                b_idx[:, None].astype(f),
                mn,
                mx,
                jnp.broadcast_to(state.tick.astype(f), (R * R,))[:, None],
            ],
            axis=1,
        )  # [R*R, 7]
        rank = jnp.cumsum(flat) - 1
        slot = jnp.where(flat, (state.rr_event_count + rank) % C, C)
        updates["rr_events"] = state.rr_events.at[slot].set(rows, mode="drop")
        updates["rr_event_count"] = (
            state.rr_event_count + jnp.sum(flat).astype(jnp.int32)
        )

    if env_dist is not None:
        updates.update(_env_collision_updates(state, params, env_dist, comm))

    return replace(state, **updates)


def _env_collision_updates(
    state: SimState, params: GbpParams, env_dist: jax.Array, comm=LOCAL
) -> dict:
    """Robot-environment overlap via the euclidean distance field
    (collisions.rs:108-140), shared by the dense and grid paths."""
    R = state.pos.shape[0]
    H, W = env_dist.shape
    ww, wh = params.world_width, params.world_height
    xf = (state.pos[:, 0] + ww / 2.0) * (W / ww)
    yf = (-state.pos[:, 1] + wh / 2.0) * (H / wh)
    xi = jnp.clip(xf, 0, W - 1).astype(jnp.int32)
    yi = jnp.clip(yf, 0, H - 1).astype(jnp.int32)
    re_overlap = state.active & (env_dist[yi, xi] < state.radius)
    new_re = re_overlap & ~state.re_overlap
    updates = dict(
        re_overlap=re_overlap,
        re_collisions=state.re_collisions
        + comm.psum(jnp.sum(new_re)).astype(jnp.int32),
        re_count=state.re_count + new_re.astype(jnp.int32),
    )
    C = state.re_events.shape[0]
    if C > 0:
        f = state.pos.dtype
        rr_ = state.radius[:, None]
        rows = jnp.concatenate(
            [
                jnp.arange(R, dtype=f)[:, None],
                state.pos - rr_,
                state.pos + rr_,
                jnp.broadcast_to(state.tick.astype(f), (R,))[:, None],
            ],
            axis=1,
        )  # [R, 6]
        rank = jnp.cumsum(new_re) - 1
        slot = jnp.where(new_re, (state.re_event_count + rank) % C, C)
        updates["re_events"] = state.re_events.at[slot].set(rows, mode="drop")
        updates["re_event_count"] = (
            state.re_event_count + jnp.sum(new_re).astype(jnp.int32)
        )
    return updates


def update_collisions_grid(
    state: SimState, params: GbpParams, env_dist: jax.Array | None = None,
    comm=LOCAL, candidates=None,
) -> SimState:
    """Grid-mode robot-robot collision events. Hysteresis is tracked with a
    per-robot table of currently-overlapping partner ids ([R, P], lowest ids
    kept) instead of the dense [R, R] matrix: an event is counted when a
    partner enters the table (same enter-edge semantics as
    collisions.rs:102-140, seen symmetrically by both robots and counted once
    with the a < b convention)."""
    Rl = state.pos.shape[0]
    P = state.rr_partner.shape[1]
    pos_all = comm.all_robots(state.pos)
    rad_all = comm.all_robots(state.radius)
    act_all = comm.all_robots(state.active)
    R = act_all.shape[0]
    # The candidate stencil covers max(comms_radius, 2 * max_robot_radius)
    # (grid_candidates) — a superset of every possible colliding pair
    # (d < radius_i + radius_j <= 2 * max_robot_radius); the exact distance
    # test below filters. Shared with connectivity via `candidates`; the
    # candidate positions/radii ride in the bucket tables, so there is no
    # per-candidate element gather here.
    cand_idx, cand_pos, cand_rad, cand_mask = (
        candidates if candidates is not None
        else grid_candidates(state, params, comm)
    )

    d2 = jnp.sum((state.pos[:, None, :] - cand_pos) ** 2, axis=-1)
    rsum = state.radius[:, None] + cand_rad
    overlap = cand_mask & (d2 < rsum * rsum)                 # [Rl, M]

    # current partner table: the P lowest overlapping ids (top_k of negated
    # keys — see update_connectivity_grid). Partners beyond P are dropped —
    # counted in rr_partner_overflow so truncation is visible (event counts
    # are exact only while this stays 0).
    key = jnp.where(overlap, cand_idx, R)
    cur = -jax.lax.top_k(-key, min(P, key.shape[1]))[0]
    if cur.shape[1] < P:  # fewer candidates than table slots
        cur = jnp.pad(cur, ((0, 0), (0, P - cur.shape[1])), constant_values=R)
    cur = jnp.where(cur < R, cur, -1).astype(jnp.int32)
    n_overlap = jnp.sum(overlap, axis=1).astype(jnp.int32)   # [R]
    dropped = jnp.sum(jnp.maximum(n_overlap - P, 0))

    prev = state.rr_partner
    is_new = (cur >= 0) & ~jnp.any(cur[:, :, None] == prev[:, None, :], axis=-1)
    me = comm.row_ids(Rl)[:, None]
    once = is_new & (cur > me)                               # count each pair once
    new_events = comm.psum(jnp.sum(once)).astype(jnp.int32)
    dropped = comm.psum(dropped).astype(jnp.int32)

    updates = dict(
        rr_partner=cur,
        rr_collisions=state.rr_collisions + new_events,
        rr_count=state.rr_count + jnp.sum(is_new, axis=1).astype(jnp.int32),
        rr_partner_overflow=state.rr_partner_overflow + dropped,
    )

    C = state.rr_events.shape[0]
    if C > 0 and getattr(comm, "n_shards", 1) > 1:
        raise NotImplementedError(
            "collision event AABB recording is single-shard only "
            "(set collision_log_capacity=0 for sharded runs)"
        )
    if C > 0:
        f = state.pos.dtype
        flat = once.reshape(-1)                              # [R*P]
        a_idx = jnp.broadcast_to(me, (R, P)).reshape(-1)
        b_idx = jnp.clip(cur, 0, R - 1).reshape(-1)
        pa, ra = state.pos[a_idx], state.radius[a_idx]
        pb, rb = state.pos[b_idx], state.radius[b_idx]
        mn = jnp.maximum(pa - ra[:, None], pb - rb[:, None])
        mx = jnp.minimum(pa + ra[:, None], pb + rb[:, None])
        rows = jnp.concatenate(
            [
                a_idx[:, None].astype(f),
                b_idx[:, None].astype(f),
                mn,
                mx,
                jnp.broadcast_to(state.tick.astype(f), (R * P,))[:, None],
            ],
            axis=1,
        )
        rank = jnp.cumsum(flat) - 1
        slot = jnp.where(flat, (state.rr_event_count + rank) % C, C)
        updates["rr_events"] = state.rr_events.at[slot].set(rows, mode="drop")
        updates["rr_event_count"] = (
            state.rr_event_count + jnp.sum(flat).astype(jnp.int32)
        )

    if env_dist is not None:
        updates.update(_env_collision_updates(state, params, env_dist))

    return replace(state, **updates)


def update_goal_areas(state: SimState, params: GbpParams) -> SimState:
    """Goal-area intersection check (goal_area.rs:67-104): a robot disc
    intersecting an area's AABB records the first-reach timestamp."""
    G = state.ga_aabb.shape[0]
    if G == 0:
        return state
    # closest point of the AABB to each robot center
    mn = state.ga_aabb[:, None, 0:2]  # [G, 1, 2]
    mx = state.ga_aabb[:, None, 2:4]
    p = state.pos[None, :, :]         # [1, R, 2]
    clamped = jnp.clip(p, mn, mx)
    d2 = jnp.sum((p - clamped) ** 2, axis=-1)  # [G, R]
    hit = state.active[None, :] & (d2 <= (state.radius[None, :] ** 2))
    now = state.tick.astype(state.ga_history.dtype) / params.hz
    first = hit & (state.ga_history < 0)
    return replace(
        state, ga_history=jnp.where(first, now, state.ga_history)
    )


# --------------------------------------------------------------------------
# the full tick
# --------------------------------------------------------------------------

def step(
    state: SimState,
    sdf: jax.Array,
    params: GbpParams,
    env_dist: jax.Array | None = None,
    comm=LOCAL,
) -> SimState:
    """One FixedUpdate tick (robot.rs:86-108 system chain).

    `comm` is the communication backend (parallel/comm.py): LOCAL for one
    address space (single chip, or GSPMD-partitioned under plain jit over
    sharded inputs), a ShardComm inside shard_map for explicit collectives.

    Matmul precision is pinned to `highest`: on a GPU the default may run
    float32 contractions in TF32, whose 10-bit mantissa breaks the
    information-form belief algebra (the covariance residual check rejects
    inversions and beliefs stop moving). Every contraction here is a tiny
    4x4/4x8 one, so full float32 costs nothing.
    """
    with jax.default_matmul_precision("highest"):
        state = activate_due_spawns(state)
        state = check_waypoints(state, params)
        # each grid consumer builds its own candidate tables at its point in
        # the system chain (collisions must see the positions moved by
        # update_prior_current, matching the dense path exactly); the tables
        # carry positions/radii so there are no per-candidate element gathers
        if params.use_grid:
            state = update_connectivity_grid(state, params, comm)
        else:
            state = update_connectivity(state, params, comm)
        state = update_failed_comms(state, params, comm)
        state = update_prior_horizon(state, params, comm)
        state = update_prior_current(state, params)
        state = iterate_gbp(state, sdf, params, comm)
        state = update_message_counts(state, params, comm)
        if params.use_grid:
            state = update_collisions_grid(state, params, env_dist, comm)
        else:
            state = update_collisions(state, params, env_dist, comm)
        state = update_goal_areas(state, params)
        state = log_positions(state, params)
    return replace(state, tick=state.tick + 1)


def log_positions(state: SimState, params: GbpParams) -> SimState:
    """Sample positions + velocities into the on-device ring buffers
    (the PositionTracker/VelocityTracker systems, tracking.rs:48-110,156-203;
    the velocity sample is the current variable's estimated velocity — the
    quantity that drives the robot's transform in update_prior_current)."""
    if params.log_every <= 0 or params.log_capacity <= 0:
        return state
    L = params.log_capacity
    do_log = (state.tick % params.log_every) == 0
    idx = jnp.where(do_log, state.log_head % L, 0)
    alive = state.active[:, None]
    sample = jnp.where(alive, state.pos, jnp.nan).astype(jnp.float32)
    vel = jnp.where(alive, state.belief_mean[:, 0, 2:4], jnp.nan).astype(jnp.float32)
    row = jnp.where(do_log, sample, state.pos_log[idx])
    vrow = jnp.where(do_log, vel, state.vel_log[idx])
    updates = dict(
        pos_log=state.pos_log.at[idx].set(row),
        vel_log=state.vel_log.at[idx].set(vrow),
        log_head=state.log_head + do_log.astype(jnp.int32),
    )

    # belief visualisation log: variable position means + marginal position
    # covariance (the live data of visualiser/factorgraphs.rs and
    # uncertainty.rs). The 2x2 position marginal of cov = inv(belief_lam) is
    # stored as (xx, xy, yy).
    Lv = state.viz_mean.shape[0]
    if Lv > 0:
        from magics_tpu.core.linalg import inv4_rowscaled

        vidx = jnp.where(do_log, state.log_head % Lv, 0)
        mean2 = state.belief_mean[..., :2].astype(jnp.float32)  # [R, V, 2]
        # row-scaled inverse: the pinned endpoints carry precision 1e30,
        # whose determinant overflows the plain cofactor inverse in f32
        cov, _ = inv4_rowscaled(state.belief_lam)
        cov3 = jnp.stack(
            [cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]], axis=-1
        ).astype(jnp.float32)
        a2 = state.active[:, None, None]
        mean2 = jnp.where(a2, mean2, jnp.nan)
        cov3 = jnp.where(a2, cov3, jnp.nan)
        mrow = jnp.where(do_log, mean2, state.viz_mean[vidx])
        crow = jnp.where(do_log, cov3, state.viz_cov[vidx])
        updates["viz_mean"] = state.viz_mean.at[vidx].set(mrow)
        updates["viz_cov"] = state.viz_cov.at[vidx].set(crow)
        # tracking-factor measurement points (visualiser/tracking.rs)
        trk2 = jnp.where(a2, state.trk_last_pos, jnp.nan).astype(jnp.float32)
        trow = jnp.where(do_log, trk2, state.viz_trk[vidx])
        updates["viz_trk"] = state.viz_trk.at[vidx].set(trow)

    return replace(state, **updates)


def run_ticks(
    state: SimState,
    sdf: jax.Array,
    params: GbpParams,
    n: int,
    env_dist: jax.Array | None = None,
    comm=LOCAL,
) -> SimState:
    """Run `n` ticks device-resident (no host sync between ticks)."""
    def body(st, _):
        return step(st, sdf, params, env_dist, comm), None

    state, _ = jax.lax.scan(body, state, None, length=n)
    return state
