"""Batched factor updates — the GBP hot path.

Each function updates *all* factors of one kind for all robots as a single
dense tensor op, exactly reproducing `FactorNode::update`
(crates/magics/src/factorgraph/factor/mod.rs:334-454):

  1. linearisation point X0 = concatenated inbox means (empty -> zeros)
  2. skip check (interrobot / tracking) -> skipped factors emit zero messages
  3. h(X0), Jacobian J
  4. potential: Lam_f = J^T Lam_m J,  eta_f = J^T Lam_m (J X0 + (z - h))
  5. per-edge: add the *other* edges' incoming messages, Schur-marginalise
     onto the edge's block (marginalise_factor_distance.rs:55-127); unary
     factors pass the potential through unchanged.

All factors have <= 2 neighbours and DOFS = 4, so marginalisation is the
closed-form two-block form in `core.linalg.marginalize_two_block`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from magics_tpu.core.constants import DOFS
from magics_tpu.core.linalg import inv4_rowscaled, marginalize_two_block, mm, mtm, mv


def dynamic_factor_messages(
    v2f_eta: jax.Array,   # [..., 2, 4]
    v2f_lam: jax.Array,   # [..., 2, 4, 4]
    v2f_mu: jax.Array,    # [..., 2, 4]
    delta_t: jax.Array,   # [...]
    sigma: float,
    dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array]:
    """Messages from all dynamic (constant-velocity) factors.

    Reference: factor/dynamic.rs:17-97. The factor is linear with z = 0, so
    eta_f = J^T Q^-1 (J X0 - J X0) = 0 and the potential precision is the
    constant J^T Q^-1 J built from the GP motion-prior blocks
    Q^-1 = sigma^-2 * [[12 dt^-3 I, -6 dt^-2 I], [-6 dt^-2 I, 4 dt^-1 I]].

    Returns (f2v_eta [..., 2, 4], f2v_lam [..., 2, 4, 4]).

    Formulation note (why this is not the generic Schur marginalisation):
    the factor relation is x_b = Phi x_a + w, w ~ N(0, Q) with the unit
    upper-triangular transition Phi = [[I, dt I], [0, I]]. The reference's
    Schur form `lbb - lba (laa + C)^-1 lab` cancels catastrophically when
    the cavity C is weak — the potential alone is rank-4 over 8 dofs, so the
    true marginal tends to EXACTLY zero information while each term stays at
    Q^-1 scale (~1e4). In float32 the roundoff left behind is comparable to
    genuinely weak messages, which either poisons the chain or forces a
    floor that drops real information (observed: horizon deceleration never
    reaches the current state and robots overshoot goals at swarm density).
    Because Phi is invertible, the Schur result rearranges EXACTLY (pure
    algebraic identity, verified to f64 roundoff against the Schur form):

        msg to b (cavity C, eta_c on a):
            S_b  = Q^-1 Phi (Phi^T Q^-1 Phi + C)^-1
            lam  = S_b C Phi^-1          eta = S_b eta_c
        msg to a (cavity D, eta_d on b):
            S_a  = Phi^T Q^-1 (Q^-1 + D)^-1
            lam  = S_a D Phi             eta = S_a eta_d

    No subtraction appears, a zero cavity yields an exactly-zero (empty)
    message, and both inverses are of full-rank PSD sums (Q^-1 is full
    rank), so dynamic factors are never skipped — matching dynamic.rs:79-91.
    """
    batch = delta_t.shape
    eye2 = jnp.eye(2, dtype=dtype)
    zero2 = jnp.zeros((2, 2), dtype=dtype)

    inv_s2 = 1.0 / (sigma * sigma)
    dt = delta_t.astype(dtype)
    q11 = (12.0 * inv_s2) / (dt * dt * dt)
    q12 = (-6.0 * inv_s2) / (dt * dt)
    q22 = (4.0 * inv_s2) / dt

    def blk(s):  # [...] -> [..., 2, 2]
        return s[..., None, None] * eye2

    qinv = jnp.concatenate(
        [
            jnp.concatenate([blk(q11), blk(q12)], axis=-1),
            jnp.concatenate([blk(q12), blk(q22)], axis=-1),
        ],
        axis=-2,
    )  # [..., 4, 4]

    # Phi = [[I, dt I], [0, I]], Phi^-1 = [[I, -dt I], [0, I]]
    # (the a-columns of the reference Jacobian J = [Phi, -I], dynamic.rs:44-49)
    dtb = dt[..., None, None] * eye2
    eye2b = jnp.broadcast_to(eye2, batch + (2, 2))
    zero2b = jnp.broadcast_to(zero2, batch + (2, 2))
    phi = jnp.concatenate(
        [
            jnp.concatenate([eye2b, dtb], axis=-1),
            jnp.concatenate([zero2b, eye2b], axis=-1),
        ],
        axis=-2,
    )  # [..., 4, 4]
    phi_inv = jnp.concatenate(
        [
            jnp.concatenate([eye2b, -dtb], axis=-1),
            jnp.concatenate([zero2b, eye2b], axis=-1),
        ],
        axis=-2,
    )

    qinv_phi = mm(qinv, phi)               # [..., 4, 4]
    m_aa = mtm(phi, qinv_phi)              # Phi^T Q^-1 Phi (== laa)

    cav_a_eta = v2f_eta[..., 0, :]
    cav_a_lam = v2f_lam[..., 0, :, :]
    cav_b_eta = v2f_eta[..., 1, :]
    cav_b_lam = v2f_lam[..., 1, :, :]

    # message to var i+1 (slot 1), cavity on var i
    t_b, _ = inv4_rowscaled(m_aa + cav_a_lam)
    s_b = mm(qinv_phi, t_b)
    m1_lam = mm(s_b, mm(cav_a_lam, phi_inv))
    m1_eta = mv(s_b, cav_a_eta)

    # message to var i (slot 0), cavity on var i+1
    t_a, _ = inv4_rowscaled(qinv + cav_b_lam)
    s_a = mm(jnp.swapaxes(qinv_phi, -1, -2), t_a)
    m0_lam = mm(s_a, mm(cav_b_lam, phi))
    m0_eta = mv(s_a, cav_b_eta)

    # symmetrise (exact result is symmetric; the product form can carry
    # tiny asymmetric roundoff) and guard non-finite inputs
    m0_lam = 0.5 * (m0_lam + jnp.swapaxes(m0_lam, -1, -2))
    m1_lam = 0.5 * (m1_lam + jnp.swapaxes(m1_lam, -1, -2))

    f2v_eta = jnp.stack([m0_eta, m1_eta], axis=-2)
    f2v_lam = jnp.stack([m0_lam, m1_lam], axis=-3)
    ok_eta = jnp.isfinite(f2v_eta)
    ok_lam = jnp.isfinite(f2v_lam)
    return jnp.where(ok_eta, f2v_eta, 0.0), jnp.where(ok_lam, f2v_lam, 0.0)


def obstacle_delta(sdf_shape: tuple[int, int], world_size: tuple[float, float]) -> float:
    """Finite-difference step = mean pixel size (obstacle.rs:98-102)."""
    H, W = sdf_shape
    ww, wh = world_size
    return (ww / W + wh / H) / 2.0


def obstacle_taps(
    v2f_mu: jax.Array,     # [..., 4]
    sdf: jax.Array,        # [H, W] float in [0, 1]
    world_size: tuple[float, float],
    dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """The three SDF samples (h0, h(+dx), h(+dy)) each obstacle factor needs."""
    H, W = sdf.shape
    ww, wh = world_size
    x_scale = W / ww
    y_scale = H / wh
    delta = obstacle_delta((H, W), world_size)

    def measure(px, py):
        # world -> pixel (obstacle.rs:147-155). Rust's `as u32` cast truncates
        # and saturates negatives to 0, so negative coordinates hit pixel 0
        # (still in bounds); only overflow past the image edge returns 0
        # ("empty space", obstacle.rs:169-176).
        xf = (px + ww / 2.0) * x_scale
        yf = (-py + wh / 2.0) * y_scale
        xi = jnp.clip(jnp.floor(jnp.maximum(xf, 0.0)), 0, W - 1).astype(jnp.int32)
        yi = jnp.clip(jnp.floor(jnp.maximum(yf, 0.0)), 0, H - 1).astype(jnp.int32)
        inside = (xf < W) & (yf < H)
        val = 1.0 - sdf[yi, xi]
        return jnp.where(inside, val, 0.0).astype(dtype)

    px = v2f_mu[..., 0]
    py = v2f_mu[..., 1]
    return measure(px, py), measure(px + delta, py), measure(px, py + delta)


def obstacle_messages_from_taps(
    h0: jax.Array,        # [...]
    hx: jax.Array,
    hy: jax.Array,
    v2f_mu: jax.Array,    # [..., 4]
    delta: float,
    sigma: float,
    dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array]:
    """Obstacle factor message arithmetic given the SDF taps."""
    jx = (hx - h0) / delta
    jy = (hy - h0) / delta
    J = jnp.stack([jx, jy, jnp.zeros_like(jx), jnp.zeros_like(jx)], axis=-1)  # [..., 4]

    lam_m = 1.0 / (sigma * sigma)
    # unary: message is the potential itself (marginalise_factor_distance.rs:63-72)
    # eta_f = J^T lam_m (J X0 + (0 - h0)); with scalar measurement this is
    # J * lam_m * (J . X0 - h0)
    jx0 = jnp.sum(J * v2f_mu.astype(dtype), axis=-1)
    eta_f = J * (lam_m * (jx0 - h0))[..., None]
    lam_f = lam_m * J[..., :, None] * J[..., None, :]
    return eta_f, lam_f


def obstacle_factor_messages(
    v2f_mu: jax.Array,     # [..., 4]
    sdf: jax.Array,        # [H, W] float in [0, 1] — the "red channel / 255"
    world_size: tuple[float, float],
    sigma: float,
    dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array]:
    """Messages from all obstacle (SDF lookup) factors.

    Reference: factor/obstacle.rs:91-216. h = 1 - sdf[pixel(x, y)] with
    nearest-pixel lookup (truncating cast, y axis flipped), 0 outside the
    image; first-order Jacobian by finite differences with
    delta = mean pixel size (only x and y contribute — velocity perturbations
    cannot change the lookup, so those columns are exactly zero).
    """
    h0, hx, hy = obstacle_taps(v2f_mu, sdf, world_size, dtype=dtype)
    delta = obstacle_delta(sdf.shape, world_size)
    return obstacle_messages_from_taps(h0, hx, hy, v2f_mu, delta, sigma, dtype=dtype)


def interrobot_factor_messages(
    x_int: jax.Array,      # [..., 4] linearisation mean of the internal variable
    x_ext: jax.Array,      # [..., 4] linearisation mean of the external variable
    v2f_int_eta: jax.Array,  # [..., 4]
    v2f_int_lam: jax.Array,  # [..., 4, 4]
    v2f_ext_eta: jax.Array,  # [..., 4]
    v2f_ext_lam: jax.Array,  # [..., 4, 4]
    safety_distance: jax.Array,  # [...]
    tiny_offset: jax.Array,      # [...]
    sigma: float,
    dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Messages from all inter-robot collision factors.

    Reference: factor/interrobot.rs:40-237. h = 1 - r/d_safe when the two
    positions are within the safety distance (else 0, and the factor is
    skipped entirely when the *raw* squared distance >= d_safe^2 —
    interrobot.rs:213-226, emitting empty messages). A tiny per-factor offset
    avoids division by zero (interrobot.rs:91-106).

    Returns (f2v_int_eta, f2v_int_lam, f2v_ext_eta, f2v_ext_lam, skipped).
    The internal-edge message is computed for parity/testing even though the
    reference drops it (factorgraph.rs:719-760); callers may ignore it.
    """
    d_raw = x_int[..., :2] - x_ext[..., :2]
    dist2_raw = jnp.sum(d_raw * d_raw, axis=-1)
    skipped = dist2_raw >= safety_distance * safety_distance

    diff = d_raw + tiny_offset[..., None]
    r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    within = r <= safety_distance

    h0 = jnp.where(within, 1.0 - r / safety_distance, 0.0).astype(dtype)

    # J (1 x 8): J[0, 0:2] = -diff / (d_safe * r), J[0, 4:6] = +diff / (d_safe * r)
    safe_r = jnp.where(r > 0, r, 1.0)
    g = jnp.where(
        within[..., None], -diff / (safety_distance[..., None] * safe_r[..., None]), 0.0
    ).astype(dtype)
    zero2 = jnp.zeros_like(g)
    J = jnp.concatenate([g, zero2, -g, zero2], axis=-1)  # [..., 8]

    lam_m = 1.0 / (sigma * sigma)
    x0 = jnp.concatenate([x_int, x_ext], axis=-1).astype(dtype)  # [..., 8]
    jx0 = jnp.sum(J * x0, axis=-1)
    eta_f = J * (lam_m * (jx0 - h0))[..., None]             # [..., 8]
    lam_f = lam_m * J[..., :, None] * J[..., None, :]       # [..., 8, 8]

    laa = lam_f[..., :4, :4]
    lab = lam_f[..., :4, 4:]
    lba = lam_f[..., 4:, :4]
    lbb = lam_f[..., 4:, 4:]
    eta_a = eta_f[..., :4]
    eta_b = eta_f[..., 4:]

    # message to the internal variable (block a); other edge = external
    int_eta, int_lam, _ = marginalize_two_block(
        eta_a, eta_b + v2f_ext_eta, laa, lab, lba, lbb + v2f_ext_lam
    )
    # message to the external variable (block b); other edge = internal
    ext_eta, ext_lam, _ = marginalize_two_block(
        eta_b, eta_a + v2f_int_eta, lbb, lba, lab, laa + v2f_int_lam
    )

    keep = ~skipped
    int_eta = jnp.where(keep[..., None], int_eta, 0.0)
    int_lam = jnp.where(keep[..., None, None], int_lam, 0.0)
    ext_eta = jnp.where(keep[..., None], ext_eta, 0.0)
    ext_lam = jnp.where(keep[..., None, None], ext_lam, 0.0)
    return int_eta, int_lam, ext_eta, ext_lam, skipped


def interrobot_rank1_messages(
    x_int: jax.Array,        # [..., 4] internal linearisation mean (snap mu)
    p_ext: jax.Array,        # [..., 2] external variable position
    cav_eta: jax.Array,      # [..., 4] internal cavity (snap eta where seeded)
    cav_lam: jax.Array,      # [..., 4, 4] internal cavity precision
    safety_distance: jax.Array,  # [...]
    tiny_offset: jax.Array,      # [...]
    sigma: float,
    dtype=jnp.float32,
) -> jax.Array:
    """Message from each inter-robot factor to its *external* variable, in
    compact rank-1 form [(gx, gy, t, s)]: eta = g*t, lam = s * g g^T.

    Exactly the reference's computation specialised to its structure: the
    potential is J^T Lam_m J with ONE measurement row J = [g, 0, -g, 0]
    (interrobot.rs:121-161), so every Schur block shares the g factor and the
    marginal onto the external variable collapses to two scalars:

        M      = alpha g g^T + cavity            (alpha = 1/sigma^2)
        q      = g^T M^-1 g
        w      = g^T M^-1 (alpha g (J x0 - h) + cav_eta)
        s      = alpha (1 - alpha q)
        t      = alpha (w - (J x0 - h))

    The external variable's own response cavity enters only the message to
    the factor's internal variable — which external_factor_iteration drops on
    the floor (factorgraph.rs:719-760) — so it does not appear here at all.
    Validity guards mirror marginalize_two_block (core/linalg.py): empty
    message on singular / non-finite / insane / negligible marginals, and on
    the skip condition (raw distance >= safety, interrobot.rs:213-226).
    """
    from magics_tpu.core.linalg import inv4_rowscaled, mv

    d_raw = x_int[..., :2] - p_ext
    dist2_raw = jnp.sum(d_raw * d_raw, axis=-1)
    skipped = dist2_raw >= safety_distance * safety_distance

    diff = d_raw + tiny_offset[..., None]
    r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    within = r <= safety_distance

    h0 = jnp.where(within, 1.0 - r / safety_distance, 0.0).astype(dtype)
    safe_r = jnp.where(r > 0, r, 1.0)
    g2 = jnp.where(
        within[..., None],
        -diff / (safety_distance[..., None] * safe_r[..., None]),
        0.0,
    ).astype(dtype)  # [..., 2] — J's position block on the internal variable

    alpha = jnp.asarray(1.0 / (sigma * sigma), dtype)
    # J x0 = g . p_int - g . p_ext (velocity columns of J are zero)
    jx0 = jnp.sum(g2 * d_raw.astype(dtype), axis=-1)
    resid = jx0 - h0  # alpha * resid is the eta scale

    g4 = jnp.concatenate([g2, jnp.zeros_like(g2)], axis=-1)  # [..., 4]
    M = alpha * g4[..., :, None] * g4[..., None, :] + cav_lam
    M_inv, det = inv4_rowscaled(M)
    Mg = mv(M_inv, g4)
    q = jnp.sum(g4 * Mg, axis=-1)
    w = jnp.sum(Mg * (alpha * resid[..., None] * g4 + cav_eta), axis=-1)

    s = alpha * (1.0 - alpha * q)
    t = alpha * (w - resid)

    # guards, mirroring marginalize_two_block on the rank-1 marginal:
    # lam_msg = s g g^T, lam_bb = alpha g g^T share the |g|^2 scale factor
    gmax2 = jnp.max(jnp.abs(g2), axis=-1) ** 2
    finite = jnp.isfinite(s) & jnp.isfinite(t)
    sane = jnp.abs(s) * gmax2 <= 4.0 * alpha * gmax2 + 1.0
    rtol = 1e-4 if dtype == jnp.float32 else 1e-12
    negligible = jnp.abs(s) * gmax2 <= rtol * alpha * gmax2
    valid = (jnp.abs(det) > 1e-6) & finite & sane & ~negligible & ~skipped

    ok = valid.astype(dtype)
    return jnp.stack([g2[..., 0] * ok, g2[..., 1] * ok, t * ok, s * ok], axis=-1)


def compact_snap_tables(
    snap_mu: jax.Array,   # [R, V, 4]
    snap_eta: jax.Array,  # [R, V, 4]
    snap_lam: jax.Array,  # [R, V, 4, 4]
    dtype=jnp.float32,
) -> jax.Array:
    """Per-robot compact cavity tables for the receiver-computes exchange:
    [R, V-1, 8] = (snap_pos 2, mc 2, S 3, valid 1) for variables 1..V-1.

    `S` is the position 2x2 block of the belief covariance C^-1 (stored as
    xx, xy, yy) and `mc = (C^-1 eta)[:2]`; with them the inter-robot rank-1
    marginal collapses to scalars via Sherman-Morrison (see
    interrobot_rank1_messages_compact). O(R V) work per pass instead of a
    4x4 inverse per (robot, slot, variable) pair.
    """
    from magics_tpu.core.linalg import inv4_rowscaled, mv

    C = snap_lam[:, 1:]
    C_inv, det = inv4_rowscaled(C)
    finite = jnp.all(jnp.isfinite(C_inv), axis=(-2, -1))
    valid = (jnp.abs(det) > 1e-6) & finite
    mc = mv(C_inv, snap_eta[:, 1:])[..., :2]
    S = jnp.stack(
        [C_inv[..., 0, 0], C_inv[..., 0, 1], C_inv[..., 1, 1]], axis=-1
    )
    zero2 = jnp.zeros_like(mc)
    return jnp.concatenate(
        [
            snap_mu[:, 1:, :2].astype(dtype),
            jnp.where(valid[..., None], mc, zero2).astype(dtype),
            jnp.where(valid[..., None], S, 0.0).astype(dtype),
            valid[..., None].astype(dtype),
        ],
        axis=-1,
    )


def interrobot_rank1_messages_compact(
    tables: jax.Array,       # [..., 8] gathered compact tables (see above)
    seeded: jax.Array,       # [...] bool — peer cavity present
    p_ext: jax.Array,        # [..., 2] external variable position
    safety_distance: jax.Array,  # [...]
    tiny_offset: jax.Array,      # [...]
    sigma: float,
    dtype=jnp.float32,
) -> jax.Array:
    """Receiver-computes fast path: same rank-1 marginal as
    `interrobot_rank1_messages` via Sherman-Morrison on the PRECOMPUTED
    belief covariance position block:

        u   = g^T S g            (S = position block of C^-1)
        den = 1 + alpha u
        s   = alpha / den
        t   = alpha (g . mc - (J x0 - h)) / den

    (exact algebraic rearrangement of M^-1 = (alpha g g^T + C)^-1 — see the
    derivation in the docstring of the exact form). Differences from the
    exact path: validity is judged on C (the cavity) instead of M, and the
    mean `mc = C^-1 eta` is recomputed rather than taken from the guarded
    belief update — both only diverge in near-singular states where the
    exact path emits empty messages anyway. f64 agreement with the exact
    path is asserted to ~1e-9 on healthy states (tests/test_receiver_ext.py).

    An UNSEEDED peer cavity (C = 0) is a special case the exact path
    resolves to an empty message (M = alpha g g^T is singular): here the
    seeded flag gates it directly.
    """
    snap_pos = tables[..., 0:2]
    mc = tables[..., 2:4]
    Sxx, Sxy, Syy = tables[..., 4], tables[..., 5], tables[..., 6]
    cav_valid = (tables[..., 7] > 0.5) & seeded

    d_raw = snap_pos - p_ext
    dist2_raw = jnp.sum(d_raw * d_raw, axis=-1)
    skipped = dist2_raw >= safety_distance * safety_distance

    diff = d_raw + tiny_offset[..., None]
    r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    within = r <= safety_distance

    h0 = jnp.where(within, 1.0 - r / safety_distance, 0.0).astype(dtype)
    safe_r = jnp.where(r > 0, r, 1.0)
    g2 = jnp.where(
        within[..., None],
        -diff / (safety_distance[..., None] * safe_r[..., None]),
        0.0,
    ).astype(dtype)

    alpha = jnp.asarray(1.0 / (sigma * sigma), dtype)
    jx0 = jnp.sum(g2 * d_raw.astype(dtype), axis=-1)
    resid = jx0 - h0

    gx, gy = g2[..., 0], g2[..., 1]
    u = gx * gx * Sxx + 2.0 * gx * gy * Sxy + gy * gy * Syy
    den = 1.0 + alpha * u
    s = alpha / den
    t = alpha * (jnp.sum(g2 * mc, axis=-1) - resid) / den

    gmax2 = jnp.max(jnp.abs(g2), axis=-1) ** 2
    finite = jnp.isfinite(s) & jnp.isfinite(t)
    rtol = 1e-4 if dtype == jnp.float32 else 1e-12
    negligible = jnp.abs(s) * gmax2 <= rtol * alpha * gmax2
    valid = cav_valid & finite & ~negligible & ~skipped

    ok = valid.astype(dtype)
    return jnp.stack([gx * ok, gy * ok, t * ok, s * ok], axis=-1)


def rank1_eta_lam(msg: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Expand compact rank-1 messages [..., (gx, gy, t, s)] to information
    form (eta [..., 4], lam [..., 4, 4]) — only the position block is ever
    nonzero."""
    gx, gy, t, s = msg[..., 0], msg[..., 1], msg[..., 2], msg[..., 3]
    z = jnp.zeros_like(gx)
    eta = jnp.stack([gx * t, gy * t, z, z], axis=-1)
    gxx, gxy, gyy = s * gx * gx, s * gx * gy, s * gy * gy
    row0 = jnp.stack([gxx, gxy, z, z], axis=-1)
    row1 = jnp.stack([gxy, gyy, z, z], axis=-1)
    rowz = jnp.stack([z, z, z, z], axis=-1)
    lam = jnp.stack([row0, row1, rowz, rowz], axis=-2)
    return eta, lam


def rank1_sum_compact(msg: jax.Array, axis: int = 1) -> jax.Array:
    """Sum compact rank-1 messages over `axis` into the five nonzero
    information-form entries [..., (eta_x, eta_y, lam_xx, lam_xy, lam_yy)]."""
    gx, gy, t, s = msg[..., 0], msg[..., 1], msg[..., 2], msg[..., 3]
    return jnp.stack(
        [
            jnp.sum(gx * t, axis=axis),
            jnp.sum(gy * t, axis=axis),
            jnp.sum(s * gx * gx, axis=axis),
            jnp.sum(s * gx * gy, axis=axis),
            jnp.sum(s * gy * gy, axis=axis),
        ],
        axis=-1,
    )


def rank1_sum(msg: jax.Array, axis: int = 1) -> tuple[jax.Array, jax.Array]:
    """Sum compact rank-1 messages over `axis`, returning dense (eta [..., 4],
    lam [..., 4, 4]) with only the 2x2 position block populated."""
    summed = rank1_sum_compact(msg, axis)
    ex, ey, lxx, lxy, lyy = (summed[..., k] for k in range(5))
    z = jnp.zeros_like(ex)
    eta = jnp.stack([ex, ey, z, z], axis=-1)
    row0 = jnp.stack([lxx, lxy, z, z], axis=-1)
    row1 = jnp.stack([lxy, lyy, z, z], axis=-1)
    rowz = jnp.stack([z, z, z, z], axis=-1)
    lam = jnp.stack([row0, row1, rowz, rowz], axis=-2)
    return eta, lam


def tracking_factor_messages(
    v2f_mu: jax.Array,      # [R, F, 4]
    path: jax.Array,        # [R, W, 2]
    path_len: jax.Array,    # [R] i32
    record: jax.Array,      # [R, F] i32
    index: jax.Array,       # [R] i32 (unused by the maths; kept for parity)
    timeout: jax.Array,     # [R, F] i32, -1 = none
    switch_padding: float,
    attraction_distance: float,
    sigma: float,
    dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Messages from all tracking (path-following) factors.

    Reference: factor/tracking.rs:96-392. Projects the variable position onto
    the path segment given by the factor's `record`, blends with the previous
    segment near switch points, pulls with magnitude = clamped normalised
    distance to the projection, and advances `record` when the projection
    nears the segment end. Skips while a timeout is pending or the path is
    exhausted (the robot-wide skip for the first 10 factor iterations is
    applied by the caller, factorgraph.rs:701).

    Returns (f2v_eta, f2v_lam, new_record, new_timeout, last_pos, last_val,
    skipped).
    """
    R, F = record.shape
    Wmax = path.shape[1]

    x_pos = v2f_mu[..., :2]    # [R, F, 2]
    x_vel = v2f_mu[..., 2:4]

    plen = path_len[:, None]   # [R, 1]
    max_record = jnp.maximum(plen - 2, 0)
    rec = jnp.clip(record, 0, jnp.maximum(plen - 2, 0))

    # segment endpoints via vectorized gather
    def gather_pt(idx):  # [R, F] -> [R, F, 2]
        idx_c = jnp.clip(idx, 0, Wmax - 1)
        batch_r = jnp.arange(R)[:, None]
        return path[batch_r, idx_c]

    cur_s = gather_pt(rec)
    cur_e = gather_pt(rec + 1)

    line = cur_e - cur_s
    line_dot = jnp.sum(line * line, axis=-1, keepdims=True)
    safe_dot = jnp.where(line_dot > 0, line_dot, 1.0)
    t_cur = jnp.sum((x_pos - cur_s) * line, axis=-1, keepdims=True) / safe_dot
    # Deliberate robustness divergence from tracking.rs:220-224 (same "TODO:
    # FIX THE SWITCHING LOGIC" block as the blend-window cap below): the
    # reference projects onto the INFINITE line through the segment. Once
    # every record has clamped to the final segment (increment_record stops
    # at len-2), variables still behind a short final segment project onto
    # the line's backward extension — a phantom measurement point metres off
    # the path that pulls at full saturated strength against the horizon
    # pull, parking the robot short of its goal (observed on Solo GP's
    # 3.3 m final segment, shorter than its switch-padding 5). Clamping to
    # the segment is the nearest-point-on-path-segment geometry and is a
    # no-op for the mid-segment case.
    t_cur = jnp.clip(t_cur, 0.0, 1.0)
    proj_cur = cur_s + t_cur * line

    d_pad = switch_padding
    d_lo = d_pad * 0.01

    cur_to_end = jnp.linalg.norm(cur_e - proj_cur, axis=-1)

    # previous-segment blend (tracking.rs:255-290)
    prev_s = gather_pt(jnp.maximum(rec - 1, 0))
    prev_e = cur_s
    pline = prev_e - prev_s
    pline_dot = jnp.sum(pline * pline, axis=-1, keepdims=True)
    psafe = jnp.where(pline_dot > 0, pline_dot, 1.0)
    t_prev = jnp.clip(
        jnp.sum((x_pos - prev_s) * pline, axis=-1, keepdims=True) / psafe,
        0.0, 1.0,
    )
    proj_prev = prev_s + t_prev * pline

    cur_proj_to_prev_end = jnp.linalg.norm(prev_e - proj_cur, axis=-1)
    prev_proj_to_prev_end = jnp.linalg.norm(cur_s - proj_prev, axis=-1)

    # Deliberate robustness divergence from tracking.rs:255-290 (whose own
    # comment reads "TODO: FIX THE SWITCHING LOGIC"): the blend window is
    # capped at half of EACH adjoining segment's length. With the
    # reference's fixed window, a segment shorter than the configured
    # switch-padding (Solo GP ships padding 5.0 and RRT* routes with 3.3 m
    # segments) keeps the corner blend engaged across the WHOLE segment:
    # the blended measurement point mp = proj_cur + proj_prev - x pulls
    # PERMANENTLY back toward the corner, deadlocking the robot against the
    # horizon pull (parks short of its goal — observed both at mid-path
    # kinks, round 4, and on the final approach when the last segment is
    # short, round 5). Corner smoothing capped at both segment midpoints
    # keeps the behavior on normally-spaced paths and removes the trap.
    prev_len = jnp.sqrt(pline_dot[..., 0])
    cur_len = jnp.sqrt(line_dot[..., 0])
    win_prev = jnp.minimum(d_pad, 0.5 * prev_len)
    win_cur = jnp.minimum(d_pad, 0.5 * cur_len)
    # prev_proj_to_prev_end > d_lo: with the segment-clamped projection a
    # variable PAST the corner degenerates proj_prev to the corner point
    # itself (distance 0) — blending there turns the measurement point into
    # proj_cur - (x - corner), a permanent backward pull that pins the
    # chain at the corner. Requiring the prev-projection to be genuinely
    # interior to the previous segment keeps the blend to its purpose:
    # smoothing the APPROACH to a corner, never holding a variable that is
    # already past it.
    use_prev = (
        (rec > 0)
        & (cur_proj_to_prev_end < win_cur)
        & (cur_proj_to_prev_end > d_lo)
        & (prev_proj_to_prev_end > d_lo)
        & (prev_proj_to_prev_end < win_prev)
    )

    # record increment (tracking.rs:292-296), clamped like increment_record
    new_record = jnp.where(
        cur_to_end < d_pad, jnp.minimum(rec + 1, max_record), rec
    )

    # measurement point (tracking.rs:299-317)
    vel_norm = jnp.linalg.norm(x_vel, axis=-1, keepdims=True)
    line_norm = jnp.linalg.norm(line, axis=-1, keepdims=True)
    line_unit = jnp.where(line_norm > 0, line / jnp.where(line_norm > 0, line_norm, 1.0), 0.0)
    mp_single = proj_cur + line_unit * vel_norm / 5.0
    mp_blend = x_pos + (proj_cur - x_pos) + (proj_prev - x_pos)
    mp = jnp.where(use_prev[..., None], mp_blend, mp_single)

    # normalised distance (tracking.rs:321-333)
    x_to_mp = mp - x_pos
    d_mp = jnp.linalg.norm(x_to_mp, axis=-1)
    h0 = jnp.minimum(d_mp / attraction_distance, 1.0).astype(dtype)

    # Jacobian (tracking.rs:171-194): J[0, :2] = (x_pos - mp) / h0
    safe_h0 = jnp.where(h0 != 0, h0, 1.0)
    g = ((x_pos - mp).astype(dtype)) / safe_h0[..., None]
    J = jnp.concatenate([g, jnp.zeros_like(g)], axis=-1)  # [R, F, 4]

    lam_m = 1.0 / (sigma * sigma)
    jx0 = jnp.sum(J * v2f_mu.astype(dtype), axis=-1)
    eta_f = J * (lam_m * (jx0 - h0))[..., None]
    lam_f = lam_m * J[..., :, None] * J[..., None, :]

    # skip logic (tracking.rs:362-381)
    timed_out = timeout > 0
    new_timeout = jnp.where(timed_out, timeout - 1, jnp.where(timeout == 0, -1, timeout))
    path_done = (plen < 2) | (rec >= plen - 1)
    skipped = timed_out | path_done | (h0 == 0)

    keep = ~skipped
    eta_f = jnp.where(keep[..., None], eta_f, 0.0)
    lam_f = jnp.where(keep[..., None, None], lam_f, 0.0)
    # record / last-measurement only advance when the factor actually measured
    # (reference skip() returns before measure); the caller keeps old values
    # where `skipped`.
    new_record = jnp.where(keep, new_record, record)
    return eta_f, lam_f, new_record, new_timeout, mp.astype(dtype), h0, skipped
