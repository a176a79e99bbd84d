"""Dense batched representation of all robots' factor graphs.

The reference keeps one petgraph `FactorGraph` per robot
(crates/magics/src/factorgraph/factorgraph.rs:76-120) and iterates nodes with
CPU threads. Here the whole swarm is a fixed-capacity pytree of dense arrays:

  R — robot capacity (padded; `active` masks live robots)
  V — variables per robot chain (current state .. horizon)
  K — inter-robot neighbour slots per robot (masked, fixed capacity)
  W — max waypoints per robot route / tracking path

Per-robot chain topology (reference robot.rs:1130-1356):
  variables 0..V-1; dynamic factor i connects variables (i, i+1), i in 0..V-2;
  obstacle + tracking factors are unary on interior variables 1..V-2;
  an inter-robot connection (r, k) carries V-1 factors, factor i in 1..V-1
  pairing r's variable i with neighbour nbr_idx[r,k]'s variable i.

Message storage follows the reference's inbox model: `*_v2f_*` are
variable->factor messages living in factor inboxes; `*_f2v_*` are
factor->variable messages living in variable inboxes. "Empty" messages are
all-zero (eta, lam, mu) — an exact semantic match, see
crates/magics/src/factorgraph/message.rs (empty payloads contribute nothing to
sums and linearisation-point slots fall back to 0, factor/mod.rs:336-349).

Inter-robot specifics mirrored from the reference:
  * A factor owned by robot r never delivers a message to r's own variable —
    `external_factor_iteration` drops internal-edge messages on the floor
    (factorgraph.rs:719-760). So only `ir_f2v_ext` exists.
  * The internal variable's response to its own inter-robot factor is always
    its full belief (its inbox entry from that factor stays empty forever), so
    we store one belief snapshot per variable (`snap_*`) instead of per-slot
    copies. The snapshot updates during internal variable passes and prior
    changes — the moments the reference pushes responses into factor inboxes.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from magics_tpu.core.constants import DOFS


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@dataclasses.dataclass(frozen=True)
class GbpParams:
    """Static per-scenario parameters (hashable; closed over by jit).

    Mirrors the relevant parts of the reference `Config` TOML schema
    (crates/gbp_config/src/lib.rs:286-684).
    """

    n_vars: int  # V
    n_slots: int  # K
    max_waypoints: int  # W

    # [gbp] sigmas (crates/gbp_config/src/lib.rs:544-594)
    sigma_pose_fixed: float = 1e-15
    sigma_factor_dynamics: float = 0.1
    sigma_factor_interrobot: float = 0.01
    sigma_factor_obstacle: float = 0.01
    sigma_factor_tracking: float = 0.1
    lookahead_multiple: int = 3

    # [gbp.factors-enabled]
    dynamic_enabled: bool = True
    interrobot_enabled: bool = True
    obstacle_enabled: bool = True
    tracking_enabled: bool = True

    # [gbp.tracking] (crates/gbp_config/src/lib.rs:500-537)
    tracking_switch_padding: float = 1.0
    tracking_attraction_distance: float = 2.0

    # schedule — static tuple of (internal, external) booleans per micro-iter
    schedule: tuple[tuple[bool, bool], ...] = ()

    # position-log cadence: sample pos every `log_every` ticks into the
    # on-device ring buffer (0 = disabled)
    log_every: int = 0
    log_capacity: int = 0

    # collision event AABB recording (export.rs:171-214); 0 disables — the
    # recording scatter materialises an [R^2, 7] buffer per tick, so keep it
    # off for swarm-scale benchmarking runs
    collision_log_capacity: int = 0

    # belief visualisation log (0 = disabled): at the log_every cadence,
    # store every variable's position mean + marginal position covariance
    # for offline playback — the data the reference's factorgraph and
    # uncertainty visualisers read live from the ECS
    # (planner/visualiser/factorgraphs.rs, uncertainty.rs). [L, R, V, 2+3]
    # f32 — experiment scale only, keep off for swarm benches.
    viz_log_capacity: int = 0

    # [robot]
    target_speed: float = 4.0
    planning_horizon_seconds: float = 5.0
    comms_radius: float = 20.0
    comms_failure_rate: float = 0.2
    safety_distance_multiplier: float = 2.2

    # Variable placement along the horizon (utils.rs:34-96); length == n_vars.
    variable_timesteps: tuple[int, ...] = ()

    # [simulation]
    hz: float = 60.0
    despawn_on_final_waypoint: bool = True

    # environment / SDF
    world_width: float = 100.0
    world_height: float = 100.0
    sdf_shape: tuple[int, int] = (200, 200)  # (rows, cols) of the SDF image

    dtype: jnp.dtype = jnp.float32

    # Inter-robot message exchange strategy (graph/tick.py external passes):
    #   "sender"           — the factor owner computes its outbox
    #                        [R, K, V-1, 4]; receivers gather it by
    #                        (peer, reciprocal-slot) — the reference's
    #                        routing shape (robot.rs:1803-1831).
    #   "receiver"         — receivers recompute the incoming message
    #                        locally from the peer's gathered snapshot
    #                        tables (identical arithmetic — bit-equal) and
    #                        a locally-maintained mirror of what the peer
    #                        holds of their own positions. Removes the
    #                        per-slot outbox gather.
    #   "receiver_compact" — like "receiver" but gathering the per-variable
    #                        compact cavity tables [R, V-1, 8] and using the
    #                        Sherman-Morrison scalar form
    #                        (factors.interrobot_rank1_messages_compact):
    #                        ~6x fewer gathered bytes and no 4x4 inverse
    #                        per pair. Numerically equivalent, not
    #                        bit-identical.
    ext_exchange: str = "sender"

    # Run the factor and belief arithmetic of the GBP passes in the fused
    # GPU kernels (kernels/gbp_slot.py, Pallas through Triton) instead of
    # XLA's lowering of graph/factors.py + graph/variables.py.
    # `pallas_interpret` runs them in interpreter mode (CPU testing).
    use_pallas: bool = False
    pallas_interpret: bool = False

    # Spatial-grid neighbour search (graph/grid.py). 0 keeps the reference's
    # dense O(R^2) scans (exact at small R); > 0 bins robots into cells of
    # this size and searches a static stencil — O(R) memory, required at
    # swarm scale. `grid_capacity` is the per-cell bucket size;
    # `collision_partners` sizes the per-robot overlap table that replaces
    # the [R, R] collision-hysteresis matrix in grid mode.
    grid_cell_size: float = 0.0
    grid_capacity: int = 16
    collision_partners: int = 8
    # Largest robot radius in the scenario (builder-derived). The collision
    # grid's search radius must cover the largest possible overlapping pair
    # (d < radius_i + radius_j), which is unrelated to the comms radius — the
    # collision stencil uses 2 * max_robot_radius, never comms_radius.
    max_robot_radius: float = 1.0

    # Schedule lowering: by default the iteration schedule unrolls at trace
    # time (fastest runtime; HLO grows linearly with schedule length — a
    # 50i+10e Circle-Experiment schedule costs ~2x the compile time of a
    # 10i+10e one). Setting `scan_schedule` lowers contiguous runs of
    # identical (internal, external) flags to one lax.scan each, bounding
    # HLO size at the cost of a scan carry per run.
    scan_schedule: bool = False

    @property
    def use_grid(self) -> bool:
        return self.grid_cell_size > 0.0

    @property
    def dt(self) -> float:
        return 1.0 / self.hz


@_pytree_dataclass
class SimState:
    """All mutable simulation state as one pytree of dense arrays."""

    # --- per-robot scalars -------------------------------------------------
    active: jax.Array        # [R] bool — spawned and not despawned
    mission_active: jax.Array  # [R] bool — MissionState::Active
    completed: jax.Array     # [R] bool — mission completed
    finished_at: jax.Array   # [R] f — virtual seconds; -1 while unfinished
    spawn_tick: jax.Array    # [R] i32 — FixedUpdate tick at which robot spawns
    pos: jax.Array           # [R, 2] — world position (the bevy Transform)
    radius: jax.Array        # [R]
    t0: jax.Array            # [R] — radius / 2 / target_speed (robot.rs:1225)
    antenna: jax.Array       # [R] bool — comms radio currently active
    iter_count_factor: jax.Array  # [R] i32 — factor-pass counter (tracking skip)
    # MissionState::Idle{waiting}: robot spawned but its in-flight global
    # plan has not arrived — spawn activation leaves mission_active False so
    # the GBP tick skips it (robot.rs:1795); cleared by mission.apply_plans
    plan_pending: jax.Array  # [R] bool

    # --- mission / route ---------------------------------------------------
    waypoints: jax.Array     # [R, W, 4] state-vector waypoints (incl. start)
    n_waypoints: jax.Array   # [R] i32
    target_idx: jax.Array    # [R] i32 — next waypoint index (starts at 1)
    wp_check_var: jax.Array  # [R] i32 — which variable checks waypoint arrival
    wp_check_dist2: jax.Array  # [R] — squared arrival distance (waypoints)
    fin_check_var: jax.Array   # [R] i32 — variable checked for final arrival
    fin_check_dist2: jax.Array  # [R]

    # --- variables ---------------------------------------------------------
    prior_mean: jax.Array    # [R, V, 4]
    prior_sigma: jax.Array   # [R, V] — diagonal prior precision
    belief_eta: jax.Array    # [R, V, 4]
    belief_lam: jax.Array    # [R, V, 4, 4]
    belief_mean: jax.Array   # [R, V, 4]
    snap_eta: jax.Array      # [R, V, 4] — belief snapshot (see module doc)
    snap_lam: jax.Array      # [R, V, 4, 4]
    snap_mu: jax.Array       # [R, V, 4]

    # --- dynamic factors (i connects vars i, i+1) --------------------------
    dyn_v2f_eta: jax.Array   # [R, V-1, 2, 4]   slot 0: var i, slot 1: var i+1
    dyn_v2f_lam: jax.Array   # [R, V-1, 2, 4, 4]
    dyn_v2f_mu: jax.Array    # [R, V-1, 2, 4]
    dyn_f2v_eta: jax.Array   # [R, V-1, 2, 4]
    dyn_f2v_lam: jax.Array   # [R, V-1, 2, 4, 4]

    # --- obstacle factors (unary on vars 1..V-2) ---------------------------
    obs_v2f_mu: jax.Array    # [R, V-2, 4]
    obs_f2v_eta: jax.Array   # [R, V-2, 4]
    obs_f2v_lam: jax.Array   # [R, V-2, 4, 4]

    # --- tracking factors (unary on vars 1..V-2) ---------------------------
    trk_v2f_mu: jax.Array    # [R, V-2, 4]
    trk_f2v_eta: jax.Array   # [R, V-2, 4]
    trk_f2v_lam: jax.Array   # [R, V-2, 4, 4]
    trk_record: jax.Array    # [R, V-2] i32
    trk_timeout: jax.Array   # [R, V-2] i32 — -1 means no timeout
    trk_index: jax.Array     # [R] i32 — waypoint index the horizon approaches
    trk_last_pos: jax.Array  # [R, V-2, 2] — last measurement point
    trk_last_val: jax.Array  # [R, V-2]
    trk_path: jax.Array      # [R, W, 2]
    trk_path_len: jax.Array  # [R] i32

    # --- inter-robot connections ------------------------------------------
    # An inter-robot factor's potential has exactly one measurement row
    # (interrobot.rs:121-161), so (a) its message to the external variable is
    # rank-1 — stored compact as (gx, gy, t, s): eta = g*t, lam = s*g*g^T
    # (factors.interrobot_rank1_messages) — and (b) the external variable's
    # response eta/lam only feed the factor's message to its OWN variable,
    # which external_factor_iteration drops on the floor
    # (factorgraph.rs:719-760), so only the response *mean position* is kept.
    nbr_idx: jax.Array       # [R, K] i32 — neighbour robot index; -1 empty
    nbr_mask: jax.Array      # [R, K] bool
    # Cached reciprocal-slot table: nbr_back[r, k] = slot k' on robot
    # j = nbr_idx[r, k] with nbr_idx[j, k'] == r. Connectivity is immutable
    # after _finish_connectivity for the rest of the tick, so this is
    # computed ONCE there and reused by every external pass and the message
    # counters instead of re-running the [R, K, K] reciprocity argmax
    # (~20x per tick in the Circle-Experiment schedule):
    nbr_back: jax.Array      # [R, K] i32
    nbr_has_back: jax.Array  # [R, K] bool — reciprocal slot exists and alive
    # RECEIVER-COMPUTES MODE (params.ext_exchange != "sender") reinterprets
    # two tables — same shapes, mirrored perspective (graph/tick.py):
    #   ir_v2f_ext_pos[r, k, i] = position of R'S OWN variable i+1 as held
    #     by the peer's factor (the mirror of the peer's row) — maintained
    #     by local writes + cheap [R]-bool gate gathers, never gathered.
    #   ir_int_seeded[r, k, i]  = whether the PEER's cavity for the
    #     reciprocal slot is seeded (mirror of the peer's row).
    #   ir_f2v_ext is unused (receivers compute their inbox directly).
    # Checkpoints record the mode's semantics — resuming a "sender"
    # checkpoint under a receiver mode (or vice versa) is undefined.
    # New in-range pairs that found no free neighbour slot (cumulative; the
    # reference connects every in-range pair uncapped, robot.rs:1441-1586 —
    # nonzero means the K truncation was active and inter-robot connectivity
    # is a nearest-K approximation for this run):
    nbr_overflow: jax.Array  # [] i32
    # Robots dropped from over-full spatial-grid buckets (grid mode only;
    # cumulative over the run). Nonzero means `grid_capacity` is undersized
    # for the density and neighbour discovery / collision detection saw a
    # subset of candidates — the in-state analogue of grid.grid_overflow
    # (the reference's all-pairs scans are uncapped, robot.rs:1362-1384):
    grid_overflow: jax.Array  # [] i32
    ir_int_seeded: jax.Array  # [R, K, V-1] bool — internal v2f ever written
    # Inbox of the factor owned by (r, k) at chain position i: the external
    # variable's latest delivered response position (its belief/changed-prior
    # mean — the factor's linearisation point for that variable):
    ir_v2f_ext_pos: jax.Array  # [R, K, V-1, 2]
    # Outbox of the factor towards the external variable, compact rank-1:
    ir_f2v_ext: jax.Array      # [R, K, V-1, 4] = (gx, gy, t, s)
    # Inbox of r's variable i+1 for the message from the factor owned by
    # neighbour (nbr_idx[r,k]) — the delivered copy (delivery is gated on the
    # receiver's antenna/mission, robot.rs:1820-1830):
    ext_inbox: jax.Array       # [R, K, V-1, 4] = (gx, gy, t, s)

    # --- bookkeeping -------------------------------------------------------
    tick: jax.Array          # [] i32 — FixedUpdate counter
    rng: jax.Array           # jax PRNG key
    # device-resident position/velocity logs (the PositionTracker and
    # VelocityTracker ring buffers, tracking.rs:48-110,156-203, kept on
    # device so host sync is once per run):
    pos_log: jax.Array       # [L, R, 2] f32; NaN where robot inactive
    vel_log: jax.Array       # [L, R, 2] f32; NaN where robot inactive
    log_head: jax.Array      # [] i32 — total samples written (ring index)
    # belief visualisation ring buffers (empty [0, ...] when disabled):
    viz_mean: jax.Array      # [Lv, R, V, 2] f32 — variable position means
    viz_cov: jax.Array       # [Lv, R, V, 3] f32 — (cov_xx, cov_xy, cov_yy)
    viz_trk: jax.Array       # [Lv, R, V-2, 2] f32 — tracking measurement pts
    # message counters [R, 4]: internal/external x sent/received
    msg_counts: jax.Array
    # collision counters (hysteresis-counted events, collisions.rs:146-227)
    rr_collisions: jax.Array   # [] i32 — robot-robot collision events (pairs)
    re_collisions: jax.Array   # [] i32 — robot-environment collision events
    rr_count: jax.Array        # [R] i32 — per-robot robot-robot events
    re_count: jax.Array        # [R] i32 — per-robot environment events
    # current-overlap hysteresis state: dense mode keeps the [R, R] matrix,
    # grid mode a per-robot partner-id table [R, P] (-1 empty) instead
    rr_overlap: jax.Array      # [R, R] bool (dense) / [R, 0] (grid)
    rr_partner: jax.Array      # [R, P] i32 (grid)   / [R, 0] (dense)
    # overlap partners beyond the P-slot table (grid mode): nonzero means
    # collision-event counts are lower bounds for this run (analogous to
    # grid_overflow for bucket capacity)
    rr_partner_overflow: jax.Array  # [] i32
    re_overlap: jax.Array      # [R] bool
    # collision event records (export.rs:171-214): ring buffers of
    # (a, b, min_x, min_y, max_x, max_y, tick) / (robot, aabb..., tick)
    rr_events: jax.Array       # [C, 7] f32
    rr_event_count: jax.Array  # [] i32 — total events seen (may exceed C)
    re_events: jax.Array       # [C, 6] f32
    re_event_count: jax.Array  # [] i32
    # goal areas (goal_area.rs:27-104): AABBs + first-reach timestamps
    ga_aabb: jax.Array         # [G, 4] (min_x, min_y, max_x, max_y)
    ga_history: jax.Array      # [G, R] f32 — virtual seconds, -1 unreached

    @property
    def n_robots(self) -> int:
        return self.active.shape[0]

    @property
    def n_vars(self) -> int:
        return self.prior_mean.shape[1]


def init_state(
    params: GbpParams,
    *,
    n_robots: int,
    start_states: np.ndarray,      # [R, 4] initial pose+velocity
    waypoints: np.ndarray,         # [R, W, 4]
    n_waypoints: np.ndarray,       # [R] i32
    radii: np.ndarray,             # [R]
    spawn_ticks: np.ndarray,       # [R] i32
    variable_timesteps: np.ndarray,  # [V] i32
    wp_check_var: np.ndarray,      # [R] i32
    wp_check_dist2: np.ndarray,    # [R]
    fin_check_var: np.ndarray,     # [R] i32
    fin_check_dist2: np.ndarray,   # [R]
    seed: int = 0,
    goal_areas: np.ndarray | None = None,  # [G, 4]
    plan_pending: np.ndarray | None = None,  # [R] bool — in-flight planning
) -> SimState:
    """Build the initial dense state for a scenario.

    Mirrors `RobotBundle::new` (robot.rs:1130-1356): variables interpolated
    from start towards the horizon point (start advanced min(dist, horizon *
    speed) towards the first waypoint), endpoint priors pinned at 1e30,
    interior priors zero; all messages empty except the tracking factors'
    initial v2f mean which is seeded with the variable's initial mean
    (factorgraph.rs:314-326: tracking factors receive a real initial message).
    """
    R, V, K, W = n_robots, params.n_vars, params.n_slots, params.max_waypoints
    f = params.dtype
    assert variable_timesteps.shape[0] == V

    start = start_states.astype(np.float64)  # [R, 4]
    first_wp = waypoints[np.arange(R), np.minimum(1, n_waypoints - 1)].astype(np.float64)

    # Horizon initialisation (robot.rs:1161-1169):
    # horizon = start + min(|g - s|, planning_horizon * speed) * normalize(g - s)
    start2goal = first_wp - start
    dist = np.linalg.norm(start2goal, axis=-1, keepdims=True)
    ph_speed = params.target_speed * params.planning_horizon_seconds
    direction = np.where(dist > 0, start2goal / np.maximum(dist, 1e-30), 0.0)
    horizon = start + np.minimum(dist, ph_speed) * direction

    ts = variable_timesteps.astype(np.float64)
    frac = ts / max(float(ts[-1]), 1.0)  # [V]
    means = start[:, None, :] + (horizon - start)[:, None, :] * frac[None, :, None]  # [R,V,4]

    prior_sigma = np.zeros((R, V), dtype=np.float64)
    prior_sigma[:, 0] = 1e30
    prior_sigma[:, -1] = 1e30

    belief_lam = np.einsum("rv,ij->rvij", prior_sigma, np.eye(DOFS))
    belief_eta = prior_sigma[..., None] * means

    Vm1, Vm2 = V - 1, max(V - 2, 0)

    zeros = lambda *shape: jnp.zeros(shape, dtype=f)
    izeros = lambda *shape: jnp.zeros(shape, dtype=jnp.int32)

    path = waypoints[:, :, :2].astype(np.float64)

    state = SimState(
        active=jnp.zeros((R,), dtype=bool),
        mission_active=jnp.zeros((R,), dtype=bool),
        completed=jnp.zeros((R,), dtype=bool),
        finished_at=jnp.full((R,), -1.0, dtype=f),
        spawn_tick=jnp.asarray(spawn_ticks, dtype=jnp.int32),
        pos=jnp.asarray(start[:, :2], dtype=f),
        radius=jnp.asarray(radii, dtype=f),
        t0=jnp.asarray(radii / 2.0 / params.target_speed, dtype=f),
        antenna=jnp.ones((R,), dtype=bool),
        iter_count_factor=izeros(R),
        plan_pending=jnp.asarray(
            plan_pending
            if plan_pending is not None
            else np.zeros(R, dtype=bool)
        ),
        waypoints=jnp.asarray(waypoints, dtype=f),
        n_waypoints=jnp.asarray(n_waypoints, dtype=jnp.int32),
        target_idx=jnp.ones((R,), dtype=jnp.int32),
        wp_check_var=jnp.asarray(wp_check_var, dtype=jnp.int32),
        wp_check_dist2=jnp.asarray(wp_check_dist2, dtype=f),
        fin_check_var=jnp.asarray(fin_check_var, dtype=jnp.int32),
        fin_check_dist2=jnp.asarray(fin_check_dist2, dtype=f),
        prior_mean=jnp.asarray(means, dtype=f),
        prior_sigma=jnp.asarray(prior_sigma, dtype=f),
        belief_eta=jnp.asarray(belief_eta, dtype=f),
        belief_lam=jnp.asarray(belief_lam, dtype=f),
        belief_mean=jnp.asarray(means, dtype=f),
        snap_eta=jnp.asarray(belief_eta, dtype=f),
        snap_lam=jnp.asarray(belief_lam, dtype=f),
        snap_mu=jnp.asarray(means, dtype=f),
        dyn_v2f_eta=zeros(R, Vm1, 2, DOFS),
        dyn_v2f_lam=zeros(R, Vm1, 2, DOFS, DOFS),
        dyn_v2f_mu=zeros(R, Vm1, 2, DOFS),
        dyn_f2v_eta=zeros(R, Vm1, 2, DOFS),
        dyn_f2v_lam=zeros(R, Vm1, 2, DOFS, DOFS),
        obs_v2f_mu=zeros(R, Vm2, DOFS),
        obs_f2v_eta=zeros(R, Vm2, DOFS),
        obs_f2v_lam=zeros(R, Vm2, DOFS, DOFS),
        # tracking factors receive a real initial message (factorgraph.rs:314-326)
        trk_v2f_mu=jnp.asarray(means[:, 1 : V - 1, :], dtype=f),
        trk_f2v_eta=zeros(R, Vm2, DOFS),
        trk_f2v_lam=zeros(R, Vm2, DOFS, DOFS),
        trk_record=izeros(R, Vm2),
        trk_timeout=jnp.full((R, Vm2), -1, dtype=jnp.int32),
        trk_index=jnp.ones((R,), dtype=jnp.int32),
        trk_last_pos=jnp.asarray(means[:, 1 : V - 1, :2], dtype=f),
        trk_last_val=zeros(R, Vm2),
        trk_path=jnp.asarray(path, dtype=f),
        trk_path_len=jnp.asarray(n_waypoints, dtype=jnp.int32),
        nbr_idx=jnp.full((R, K), -1, dtype=jnp.int32),
        nbr_mask=jnp.zeros((R, K), dtype=bool),
        nbr_back=jnp.zeros((R, K), dtype=jnp.int32),
        nbr_has_back=jnp.zeros((R, K), dtype=bool),
        nbr_overflow=jnp.asarray(0, dtype=jnp.int32),
        grid_overflow=jnp.asarray(0, dtype=jnp.int32),
        ir_int_seeded=jnp.zeros((R, K, Vm1), dtype=bool),
        ir_v2f_ext_pos=zeros(R, K, Vm1, 2),
        ir_f2v_ext=zeros(R, K, Vm1, DOFS),
        ext_inbox=zeros(R, K, Vm1, DOFS),
        tick=jnp.asarray(0, dtype=jnp.int32),
        rng=jax.random.PRNGKey(seed),
        pos_log=jnp.full((params.log_capacity, R, 2), jnp.nan, dtype=jnp.float32),
        vel_log=jnp.full((params.log_capacity, R, 2), jnp.nan, dtype=jnp.float32),
        log_head=jnp.asarray(0, dtype=jnp.int32),
        viz_mean=jnp.full(
            (params.viz_log_capacity, R, V, 2), jnp.nan, dtype=jnp.float32
        ),
        viz_cov=jnp.full(
            (params.viz_log_capacity, R, V, 3), jnp.nan, dtype=jnp.float32
        ),
        viz_trk=jnp.full(
            (params.viz_log_capacity, R, Vm2, 2), jnp.nan, dtype=jnp.float32
        ),
        msg_counts=izeros(R, 4),
        rr_collisions=jnp.asarray(0, dtype=jnp.int32),
        re_collisions=jnp.asarray(0, dtype=jnp.int32),
        rr_count=izeros(R),
        re_count=izeros(R),
        rr_overlap=jnp.zeros((R, 0 if params.use_grid else R), dtype=bool),
        rr_partner=jnp.full(
            (R, params.collision_partners if params.use_grid else 0),
            -1,
            dtype=jnp.int32,
        ),
        rr_partner_overflow=jnp.asarray(0, dtype=jnp.int32),
        re_overlap=jnp.zeros((R,), dtype=bool),
        rr_events=jnp.zeros((params.collision_log_capacity, 7), dtype=jnp.float32),
        rr_event_count=jnp.asarray(0, dtype=jnp.int32),
        re_events=jnp.zeros((params.collision_log_capacity, 6), dtype=jnp.float32),
        re_event_count=jnp.asarray(0, dtype=jnp.int32),
        ga_aabb=jnp.asarray(
            goal_areas if goal_areas is not None else np.zeros((0, 4)), dtype=f
        ),
        ga_history=jnp.full(
            ((0 if goal_areas is None else len(goal_areas)), R), -1.0, dtype=f
        ),
    )
    return state
