"""Fused GBP slot kernels for NVIDIA GPUs (Pallas through Triton).

One internal GBP slot is the internal factor pass plus the internal variable
pass (factorgraph.rs:686-714, 762-790). XLA lowers the per-field dense
implementation (graph/factors.py, graph/variables.py) to many small fusions
per slot. Here a slot is two kernels:

  factor kernel    every dynamic, obstacle and tracking factor message
  belief kernel    belief = prior + inbox, guarded 4x4 inverse, and (for the
                   internal pass) the responses to the internal factors

The belief kernel without responses is also the external variable pass's
belief update (factorgraph.rs:794-826).

Layout. Each program takes BLOCK (robot, variable) pairs with flat index
p = r * V + v, one pair per thread. Every field stays in the state's own
row-major layout, viewed as a 2-D [rows, components] table. A pair's chain
neighbours (dynamic edges v and v-1, interior slot v-1) are row loads at an
offset, under a mask, so no value is ever sliced or shifted and every value
is a [BLOCK] vector. The SDF and tracking-path lookups are gathers from their
tables inside the kernel. Outputs alias their inputs and every store is
masked by the pass's gate, so untouched rows keep their values exactly as the
`jnp.where(gate, new, old)` of the XLA passes does. Blocks run independently:
no program reads what another writes.

The arithmetic mirrors graph/factors.py, graph/variables.py and
core/linalg.py term by term, including the empty-message guards, so the two
paths agree to float roundoff (tests/test_pallas_slot.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from magics_tpu.graph.factors import obstacle_delta, rank1_sum_compact

BLOCK = 128      # (robot, variable) pairs per program, one per thread
NUM_WARPS = 4    # BLOCK / 32


# --------------------------------------------------------------------------
# 4x4 algebra on [BLOCK] vectors. Structural zeros and ones are Python
# floats, so products with them cost nothing.
# --------------------------------------------------------------------------

def _is(x, c):
    return isinstance(x, float) and x == c


def _mul(a, b):
    if _is(a, 0.0) or _is(b, 0.0):
        return 0.0
    if _is(a, 1.0):
        return b
    if _is(b, 1.0):
        return a
    return a * b


def _add(a, b):
    if _is(a, 0.0):
        return b
    if _is(b, 0.0):
        return a
    return a + b


def _sum(xs):
    out = 0.0
    for x in xs:
        out = _add(out, x)
    return out


def _mm(a, b):
    return [[_sum(_mul(a[i][k], b[k][j]) for k in range(4)) for j in range(4)]
            for i in range(4)]


def _mv(a, v):
    return [_sum(_mul(a[i][k], v[k]) for k in range(4)) for i in range(4)]


def _tr(a):
    return [[a[j][i] for j in range(4)] for i in range(4)]


def _madd(a, b):
    return [[_add(a[i][j], b[i][j]) for j in range(4)] for i in range(4)]


def _inv4_rowscaled(m):
    """core.linalg.inv4_rowscaled on vectors: (inverse, det of scaled)."""
    rowmax = [
        jnp.maximum(jnp.maximum(abs(m[i][0]), abs(m[i][1])),
                    jnp.maximum(abs(m[i][2]), abs(m[i][3])))
        for i in range(4)
    ]
    d = [jnp.where(rm > 0.0, 1.0 / rm, 1.0) for rm in rowmax]
    a = [[m[i][j] * d[i] for j in range(4)] for i in range(4)]

    c01 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    c02 = a[0][0] * a[1][2] - a[0][2] * a[1][0]
    c03 = a[0][0] * a[1][3] - a[0][3] * a[1][0]
    c12 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c13 = a[0][1] * a[1][3] - a[0][3] * a[1][1]
    c23 = a[0][2] * a[1][3] - a[0][3] * a[1][2]
    d01 = a[2][0] * a[3][1] - a[2][1] * a[3][0]
    d02 = a[2][0] * a[3][2] - a[2][2] * a[3][0]
    d03 = a[2][0] * a[3][3] - a[2][3] * a[3][0]
    d12 = a[2][1] * a[3][2] - a[2][2] * a[3][1]
    d13 = a[2][1] * a[3][3] - a[2][3] * a[3][1]
    d23 = a[2][2] * a[3][3] - a[2][3] * a[3][2]
    det = c01 * d23 - c02 * d13 + c03 * d12 + c12 * d03 - c13 * d02 + c23 * d01

    adj = [
        [a[1][1] * d23 - a[1][2] * d13 + a[1][3] * d12,
         -a[0][1] * d23 + a[0][2] * d13 - a[0][3] * d12,
         a[3][1] * c23 - a[3][2] * c13 + a[3][3] * c12,
         -a[2][1] * c23 + a[2][2] * c13 - a[2][3] * c12],
        [-a[1][0] * d23 + a[1][2] * d03 - a[1][3] * d02,
         a[0][0] * d23 - a[0][2] * d03 + a[0][3] * d02,
         -a[3][0] * c23 + a[3][2] * c03 - a[3][3] * c02,
         a[2][0] * c23 - a[2][2] * c03 + a[2][3] * c02],
        [a[1][0] * d13 - a[1][1] * d03 + a[1][3] * d01,
         -a[0][0] * d13 + a[0][1] * d03 - a[0][3] * d01,
         a[3][0] * c13 - a[3][1] * c03 + a[3][3] * c01,
         -a[2][0] * c13 + a[2][1] * c03 - a[2][3] * c01],
        [-a[1][0] * d12 + a[1][1] * d02 - a[1][2] * d01,
         a[0][0] * d12 - a[0][1] * d02 + a[0][2] * d01,
         -a[3][0] * c12 + a[3][1] * c02 - a[3][2] * c01,
         a[2][0] * c12 - a[2][1] * c02 + a[2][2] * c01],
    ]
    inv = [[adj[i][j] / det * d[j] for j in range(4)] for i in range(4)]
    return inv, det


# --------------------------------------------------------------------------
# loads and stores on [rows, components] tables
# --------------------------------------------------------------------------

def _ld(ref, rows, mask, col=None):
    at = ref.at[rows] if col is None else ref.at[rows, col]
    return plgpu.load(at, mask=mask, other=0)


def _st(ref, rows, mask, val, like, col=None):
    if isinstance(val, float):
        val = jnp.full_like(like, val)
    # masked-off lanes point one row past the end: the GPU never touches
    # them, and the interpreter's scatter drops them instead of writing
    # back stale values over an active lane's row
    rows = jnp.where(mask, rows, ref.shape[0])
    at = ref.at[rows] if col is None else ref.at[rows, col]
    plgpu.store(at, val.astype(ref.dtype), mask=mask)


def _ld_vec(ref, rows, mask, off=0, n=4):
    return [_ld(ref, rows, mask, off + i) for i in range(n)]


def _ld_mat(ref, rows, mask, off=0):
    return [[_ld(ref, rows, mask, off + 4 * i + j) for j in range(4)]
            for i in range(4)]


def _st_vec(ref, rows, mask, vec, like, off=0):
    for i, x in enumerate(vec):
        _st(ref, rows, mask, x, like, off + i)


def _st_mat(ref, rows, mask, mat, like, off=0):
    for i in range(4):
        for j in range(4):
            _st(ref, rows, mask, mat[i][j], like, off + 4 * i + j)


def _pairs(n_pairs: int, V: int):
    """This program's flat (robot, variable) pair indices and their parts."""
    p = pl.program_id(0) * BLOCK + lax.iota(jnp.int32, BLOCK)
    ok = p < n_pairs
    p = jnp.where(ok, p, 0)
    V = jnp.int32(V)
    return p, ok, lax.div(p, V), lax.rem(p, V)


# --------------------------------------------------------------------------
# factor kernel
# --------------------------------------------------------------------------

def _dynamic_messages(cav_a_eta, cav_a_lam, cav_b_eta, cav_b_lam, dt, sigma):
    """factors.dynamic_factor_messages for one edge: (m0, m1) with m0 to
    var e (cavity on e+1) and m1 to var e+1 (cavity on e)."""
    inv_s2 = 1.0 / (sigma * sigma)
    q11 = (12.0 * inv_s2) / (dt * dt * dt)
    q12 = (-6.0 * inv_s2) / (dt * dt)
    q22 = (4.0 * inv_s2) / dt

    def expand(b):  # 2x2 scalar blocks -> 4x4 (kron with I2)
        m = [[0.0] * 4 for _ in range(4)]
        for bi in range(2):
            for bj in range(2):
                for c in range(2):
                    m[2 * bi + c][2 * bj + c] = b[bi][bj]
        return m

    qinv = expand([[q11, q12], [q12, q22]])
    phi = expand([[1.0, dt], [0.0, 1.0]])
    phi_inv = expand([[1.0, -dt], [0.0, 1.0]])
    qinv_phi = _mm(qinv, phi)
    m_aa = _mm(_tr(phi), qinv_phi)

    t_b, _ = _inv4_rowscaled(_madd(m_aa, cav_a_lam))
    s_b = _mm(qinv_phi, t_b)
    m1_lam = _mm(s_b, _mm(cav_a_lam, phi_inv))
    m1_eta = _mv(s_b, cav_a_eta)

    t_a, _ = _inv4_rowscaled(_madd(qinv, cav_b_lam))
    s_a = _mm(_tr(qinv_phi), t_a)
    m0_lam = _mm(s_a, _mm(cav_b_lam, phi))
    m0_eta = _mv(s_a, cav_b_eta)

    def clean(eta, lam):
        lam = [[0.5 * (lam[i][j] + lam[j][i]) for j in range(4)]
               for i in range(4)]
        fin = lambda x: jnp.where(jnp.isfinite(x), x, 0.0)
        return [fin(x) for x in eta], [[fin(x) for x in row] for row in lam]

    return clean(m0_eta, m0_lam), clean(m1_eta, m1_lam)


def _unary_messages(jx, jy, mu, h0, sigma):
    """Unary factor with Jacobian (jx, jy, 0, 0): the potential itself."""
    lam_m = 1.0 / (sigma * sigma)
    J = [jx, jy, 0.0, 0.0]
    jx0 = jx * mu[0] + jy * mu[1]
    scale = lam_m * (jx0 - h0)
    eta = [_mul(J[i], scale) for i in range(4)]
    lam = [[_mul(_mul(lam_m, J[i]), J[j]) for j in range(4)] for i in range(4)]
    return eta, lam


def _norm2(x, y):
    return jnp.sqrt(x * x + y * y)


def _factor_kernel(cfg, names, *refs):
    n = len(names)
    ins = dict(zip(names, refs[:n]))
    outs = dict(zip(cfg["outputs"], refs[n:]))
    R, V = cfg["R"], cfg["V"]
    V1, V2 = V - 1, V - 2
    p, ok, r, v = _pairs(R * V, V)
    g = _ld(ins["gate"], r, ok) != 0
    like = jnp.zeros((BLOCK,), ins["t0"].dtype)

    if cfg["dynamic"]:
        has = ok & (v < V1)
        e = r * V1 + jnp.minimum(v, V1 - 1)
        dt = _ld(ins["t0"], r, ok) * _ld(ins["gaps"], jnp.minimum(v, V1 - 1), ok)
        dt = jnp.where(has, dt, 1.0)
        v2f_eta, v2f_lam = ins["dyn_v2f_eta"], ins["dyn_v2f_lam"]
        (m0_eta, m0_lam), (m1_eta, m1_lam) = _dynamic_messages(
            _ld_vec(v2f_eta, e, has, 0), _ld_mat(v2f_lam, e, has, 0),
            _ld_vec(v2f_eta, e, has, 4), _ld_mat(v2f_lam, e, has, 16),
            dt, cfg["sigma_dynamics"],
        )
        m = has & g
        _st_vec(outs["dyn_f2v_eta"], e, m, m0_eta, like, 0)
        _st_vec(outs["dyn_f2v_eta"], e, m, m1_eta, like, 4)
        _st_mat(outs["dyn_f2v_lam"], e, m, m0_lam, like, 0)
        _st_mat(outs["dyn_f2v_lam"], e, m, m1_lam, like, 16)

    if not (cfg["obstacle"] or cfg["tracking"]):
        return
    inner = ok & (v >= 1) & (v <= V2)
    i = r * V2 + jnp.clip(v - 1, 0, V2 - 1)

    if cfg["obstacle"]:
        mu = _ld_vec(ins["obs_v2f_mu"], i, inner)
        H, W = cfg["sdf_shape"]
        ww, wh = cfg["world"]
        delta = obstacle_delta((H, W), (ww, wh))

        def measure(px, py):  # factors.obstacle_taps
            xf = (px + ww / 2.0) * (W / ww)
            yf = (-py + wh / 2.0) * (H / wh)
            xi = jnp.clip(jnp.floor(jnp.maximum(xf, 0.0)), 0, W - 1).astype(jnp.int32)
            yi = jnp.clip(jnp.floor(jnp.maximum(yf, 0.0)), 0, H - 1).astype(jnp.int32)
            inside = (xf < W) & (yf < H)
            val = 1.0 - _ld(ins["sdf"], yi * W + xi, inner)
            return jnp.where(inside, val, 0.0).astype(like.dtype)

        h0 = measure(mu[0], mu[1])
        hx = measure(mu[0] + delta, mu[1])
        hy = measure(mu[0], mu[1] + delta)
        eta, lam = _unary_messages(
            (hx - h0) / delta, (hy - h0) / delta, mu, h0, cfg["sigma_obstacle"]
        )
        m = inner & g
        _st_vec(outs["obs_f2v_eta"], i, m, eta, like)
        _st_mat(outs["obs_f2v_lam"], i, m, lam, like)

    if cfg["tracking"]:
        _tracking(cfg, ins, outs, i, r, inner, like)


def _tracking(cfg, ins, outs, i, r, inner, like):
    """factors.tracking_factor_messages for one interior variable, gated
    like tick.internal_factor_pass."""
    Wmax = cfg["max_waypoints"]
    tg = (_ld(ins["tgate"], r, inner) != 0) & inner
    mu = _ld_vec(ins["trk_v2f_mu"], i, inner)
    x, y = mu[0], mu[1]
    record = _ld(ins["trk_record"], i, inner)
    timeout = _ld(ins["trk_timeout"], i, inner)
    plen = _ld(ins["trk_path_len"], r, inner)
    max_record = jnp.maximum(plen - 2, 0)
    rec = jnp.clip(record, 0, max_record)

    def pt(idx):
        row = r * Wmax + jnp.clip(idx, 0, Wmax - 1)
        return (_ld(ins["trk_path"], row, inner, 0),
                _ld(ins["trk_path"], row, inner, 1))

    sx, sy = pt(rec)
    ex, ey = pt(rec + 1)
    lx, ly = ex - sx, ey - sy
    line_dot = lx * lx + ly * ly
    safe_dot = jnp.where(line_dot > 0, line_dot, 1.0)
    t_cur = jnp.clip(((x - sx) * lx + (y - sy) * ly) / safe_dot, 0.0, 1.0)
    pcx, pcy = sx + t_cur * lx, sy + t_cur * ly

    d_pad = cfg["switch_padding"]
    d_lo = d_pad * 0.01
    cur_to_end = _norm2(ex - pcx, ey - pcy)

    psx, psy = pt(jnp.maximum(rec - 1, 0))
    plx, ply = sx - psx, sy - psy
    pline_dot = plx * plx + ply * ply
    psafe = jnp.where(pline_dot > 0, pline_dot, 1.0)
    t_prev = jnp.clip(((x - psx) * plx + (y - psy) * ply) / psafe, 0.0, 1.0)
    ppx, ppy = psx + t_prev * plx, psy + t_prev * ply

    cur_proj_to_prev_end = _norm2(sx - pcx, sy - pcy)
    prev_proj_to_prev_end = _norm2(sx - ppx, sy - ppy)
    win_prev = jnp.minimum(d_pad, 0.5 * jnp.sqrt(pline_dot))
    win_cur = jnp.minimum(d_pad, 0.5 * jnp.sqrt(line_dot))
    use_prev = (
        (rec > 0)
        & (cur_proj_to_prev_end < win_cur)
        & (cur_proj_to_prev_end > d_lo)
        & (prev_proj_to_prev_end > d_lo)
        & (prev_proj_to_prev_end < win_prev)
    )
    new_record = jnp.where(
        cur_to_end < d_pad, jnp.minimum(rec + 1, max_record), rec
    )

    vel_norm = _norm2(mu[2], mu[3])
    line_norm = _norm2(lx, ly)
    safe_ln = jnp.where(line_norm > 0, line_norm, 1.0)
    ux = jnp.where(line_norm > 0, lx / safe_ln, 0.0)
    uy = jnp.where(line_norm > 0, ly / safe_ln, 0.0)
    mpx = jnp.where(use_prev, x + (pcx - x) + (ppx - x), pcx + ux * vel_norm / 5.0)
    mpy = jnp.where(use_prev, y + (pcy - y) + (ppy - y), pcy + uy * vel_norm / 5.0)

    h0 = jnp.minimum(_norm2(mpx - x, mpy - y) / cfg["attraction_distance"], 1.0)
    safe_h0 = jnp.where(h0 != 0, h0, 1.0)
    eta, lam = _unary_messages(
        (x - mpx) / safe_h0, (y - mpy) / safe_h0, mu, h0, cfg["sigma_tracking"]
    )

    timed_out = timeout > 0
    new_timeout = jnp.where(
        timed_out, timeout - 1, jnp.where(timeout == 0, -1, timeout)
    )
    path_done = (plen < 2) | (rec >= plen - 1)
    skipped = timed_out | path_done | (h0 == 0)
    keep = ~skipped
    eta = [jnp.where(keep, x_, 0.0) if not isinstance(x_, float) else x_
           for x_ in eta]
    lam = [[jnp.where(keep, x_, 0.0) if not isinstance(x_, float) else x_
            for x_ in row] for row in lam]

    _st_vec(outs["trk_f2v_eta"], i, tg, eta, like)
    _st_mat(outs["trk_f2v_lam"], i, tg, lam, like)
    _st(outs["trk_record"], i, tg, jnp.where(keep, new_record, record), like)
    _st(outs["trk_timeout"], i, tg, new_timeout, like)
    measured = tg & keep
    _st(outs["trk_last_pos"], i, measured, mpx, like, 0)
    _st(outs["trk_last_pos"], i, measured, mpy, like, 1)
    _st(outs["trk_last_val"], i, measured, h0, like)


# --------------------------------------------------------------------------
# belief kernel
# --------------------------------------------------------------------------

def _belief_kernel(cfg, names, *refs):
    n = len(names)
    ins = dict(zip(names, refs[:n]))
    outs = dict(zip(cfg["outputs"], refs[n:]))
    R, V = cfg["R"], cfg["V"]
    V1, V2 = V - 1, V - 2
    p, ok, r, v = _pairs(R * V, V)
    g = (_ld(ins["gate"], r, ok) != 0) & ok
    like = _ld(ins["prior_sigma"], p, ok)

    # variables.sum_messages, in its order of additions
    sig = like
    prior = _ld_vec(ins["prior_mean"], p, ok)
    eta = [sig * prior[k] for k in range(4)]
    lam = [[sig if a == b else 0.0 for b in range(4)] for a in range(4)]
    has0 = ok & (v < V1)
    has1 = ok & (v >= 1)
    e0 = r * V1 + jnp.minimum(v, V1 - 1)
    e1 = r * V1 + jnp.maximum(v - 1, 0)
    f0_eta = _ld_vec(ins["dyn_f2v_eta"], e0, has0, 0)
    f1_eta = _ld_vec(ins["dyn_f2v_eta"], e1, has1, 4)
    f0_lam = _ld_mat(ins["dyn_f2v_lam"], e0, has0, 0)
    f1_lam = _ld_mat(ins["dyn_f2v_lam"], e1, has1, 16)
    eta = [_add(_add(eta[k], f0_eta[k]), f1_eta[k]) for k in range(4)]
    lam = _madd(_madd(lam, f0_lam), f1_lam)
    inner = ok & (v >= 1) & (v <= V2)
    i = r * V2 + jnp.clip(v - 1, 0, V2 - 1)
    if V2 > 0:
        for kind in ("obs", "trk"):
            eta = [_add(eta[k], x) for k, x in
                   enumerate(_ld_vec(ins[f"{kind}_f2v_eta"], i, inner))]
            lam = _madd(lam, _ld_mat(ins[f"{kind}_f2v_lam"], i, inner))
    ext = _ld_vec(ins["ext_sum"], e1, has1, 0, 5)  # ex, ey, lxx, lxy, lyy
    eta = [_add(eta[0], ext[0]), _add(eta[1], ext[1]), eta[2], eta[3]]
    ext_lam = [[ext[2], ext[3], 0.0, 0.0], [ext[3], ext[4], 0.0, 0.0],
               [0.0] * 4, [0.0] * 4]
    lam = _madd(lam, ext_lam)
    eta = [x if not isinstance(x, float) else jnp.full_like(like, x) for x in eta]
    lam = [[x if not isinstance(x, float) else jnp.full_like(like, x)
            for x in row] for row in lam]

    # variables.update_beliefs + linalg.belief_covariance
    pnz = functools.reduce(
        jnp.logical_or, [lam[a][b] > 1e-6 for a in range(4) for b in range(4)]
    )
    cov, det = _inv4_rowscaled(lam)
    resid = jnp.zeros_like(like)
    finite = jnp.isfinite(cov[0][0])
    for a in range(4):
        for b in range(4):
            lc = _sum(lam[a][k] * cov[k][b] for k in range(4))
            resid = jnp.maximum(resid, abs(lc - (1.0 if a == b else 0.0)))
            finite = finite & jnp.isfinite(cov[a][b])
    valid = pnz & (det != 0.0) & finite & (resid < 1e-4)
    old_mean = _ld_vec(ins["belief_mean"], p, ok)
    mean = [jnp.where(valid, _sum(cov[a][k] * eta[k] for k in range(4)),
                      old_mean[a]) for a in range(4)]

    _st_vec(outs["belief_eta"], p, g, eta, like)
    _st_mat(outs["belief_lam"], p, g, lam, like)
    _st_vec(outs["belief_mean"], p, g, mean, like)
    if not cfg["responses"]:
        return

    # tick.internal_variable_pass: snapshots and internal-factor responses
    _st_vec(outs["snap_eta"], p, g, eta, like)
    _st_mat(outs["snap_lam"], p, g, lam, like)
    _st_vec(outs["snap_mu"], p, g, mean, like)
    if cfg["dynamic"]:
        m0, m1 = g & has0, g & has1
        sub = lambda a_, b_: [[a_[x][y] - b_[x][y] for y in range(4)]
                              for x in range(4)]
        _st_vec(outs["dyn_v2f_eta"], e0, m0,
                [eta[k] - f0_eta[k] for k in range(4)], like, 0)
        _st_vec(outs["dyn_v2f_eta"], e1, m1,
                [eta[k] - f1_eta[k] for k in range(4)], like, 4)
        _st_mat(outs["dyn_v2f_lam"], e0, m0, sub(lam, f0_lam), like, 0)
        _st_mat(outs["dyn_v2f_lam"], e1, m1, sub(lam, f1_lam), like, 16)
        _st_vec(outs["dyn_v2f_mu"], e0, m0, mean, like, 0)
        _st_vec(outs["dyn_v2f_mu"], e1, m1, mean, like, 4)
    for kind in ("obs", "trk"):
        if cfg[{"obs": "obstacle", "trk": "tracking"}[kind]] and V2 > 0:
            _st_vec(outs[f"{kind}_v2f_mu"], i, g & inner, mean, like)


# --------------------------------------------------------------------------
# agreement with the XLA passes
# --------------------------------------------------------------------------

# Largest |kernel - XLA| per field after one slot, relative to
# max(max |XLA field|, 1): float32 roundoff of reordered sums, amplified by
# the 4x4 inverses (messages), and once more by the mean solve (means).
# Integer fields must match exactly.
SLOT_TOLERANCE = {
    **dict.fromkeys(
        ("belief_eta", "belief_lam", "snap_eta", "snap_lam",
         "dyn_f2v_eta", "dyn_f2v_lam", "dyn_v2f_eta", "dyn_v2f_lam",
         "obs_f2v_eta", "obs_f2v_lam", "trk_f2v_eta", "trk_f2v_lam",
         "trk_last_val"), 1e-3),
    **dict.fromkeys(
        ("belief_mean", "snap_mu", "dyn_v2f_mu", "obs_v2f_mu", "trk_v2f_mu",
         "trk_last_pos"), 1e-2),
    **dict.fromkeys(("trk_record", "trk_timeout"), 0.0),
}


def slot_mismatches(ref, got) -> list[tuple[str, float, float]]:
    """Fields of two SimStates that disagree beyond SLOT_TOLERANCE, as
    (field, max abs difference, allowed)."""
    import numpy as np

    bad = []
    for field, rtol in SLOT_TOLERANCE.items():
        a = np.asarray(getattr(ref, field)).astype(np.float64)
        b = np.asarray(getattr(got, field)).astype(np.float64)
        allowed = rtol * max(float(np.abs(a).max(initial=0.0)), 1.0)
        err = float(np.abs(a - b).max(initial=0.0))
        if not err <= allowed:
            bad.append((field, err, allowed))
    return bad


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _call(kernel, cfg, inputs: dict, *, interpret: bool) -> dict:
    """pallas_call over all (robot, variable) pairs; `cfg["outputs"]` name
    the inputs updated in place."""
    names = tuple(inputs)
    outputs = cfg["outputs"]
    args = [inputs[k] for k in names]
    out = pl.pallas_call(
        functools.partial(kernel, cfg, names),
        out_shape=[jax.ShapeDtypeStruct(inputs[k].shape, inputs[k].dtype)
                   for k in outputs],
        grid=(pl.cdiv(cfg["R"] * cfg["V"], BLOCK),),
        input_output_aliases={names.index(k): j for j, k in enumerate(outputs)},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*args)
    return dict(zip(outputs, out))


def _rows(x):
    """[R, V, ...] -> [R * V, prod(...)] (or [R * V] for scalar fields)."""
    lead = x.shape[0] * x.shape[1]
    return x.reshape((lead, -1) if x.ndim > 2 else (lead,))


def _cfg(params, R: int, **extra) -> dict:
    """Static kernel configuration; the wrapper adds `outputs`, the input
    fields the kernel updates in place."""
    V = params.n_vars
    return dict(
        R=R, V=V,
        dynamic=params.dynamic_enabled,
        obstacle=params.obstacle_enabled and V > 2,
        tracking=params.tracking_enabled and V > 2,
        **extra,
    )


def factor_pass(state, sdf, params, gate, tgate, *, interpret=False) -> dict:
    """The internal factor pass's message fields (tick.internal_factor_pass)
    for robots where `gate` ([R] bool) holds; tracking where `tgate` holds."""
    R, V = state.prior_mean.shape[:2]
    f = state.prior_mean.dtype
    ts = jnp.asarray(params.variable_timesteps, dtype=f)
    cfg = _cfg(
        params, R,
        sigma_dynamics=params.sigma_factor_dynamics,
        sigma_obstacle=params.sigma_factor_obstacle,
        sigma_tracking=params.sigma_factor_tracking,
        sdf_shape=tuple(sdf.shape),
        world=(params.world_width, params.world_height),
        switch_padding=params.tracking_switch_padding,
        attraction_distance=params.tracking_attraction_distance,
        max_waypoints=state.trk_path.shape[1],
    )
    ins = {"gate": gate.astype(jnp.int32), "t0": state.t0,
           "gaps": ts[1:] - ts[:-1]}
    outputs = []
    if cfg["dynamic"]:
        ins.update(
            dyn_v2f_eta=_rows(state.dyn_v2f_eta), dyn_v2f_lam=_rows(state.dyn_v2f_lam),
            dyn_f2v_eta=_rows(state.dyn_f2v_eta), dyn_f2v_lam=_rows(state.dyn_f2v_lam),
        )
        outputs += ["dyn_f2v_eta", "dyn_f2v_lam"]
    if cfg["obstacle"]:
        ins.update(
            sdf=sdf.reshape(-1), obs_v2f_mu=_rows(state.obs_v2f_mu),
            obs_f2v_eta=_rows(state.obs_f2v_eta), obs_f2v_lam=_rows(state.obs_f2v_lam),
        )
        outputs += ["obs_f2v_eta", "obs_f2v_lam"]
    if cfg["tracking"]:
        trk = ("trk_f2v_eta", "trk_f2v_lam", "trk_record", "trk_timeout",
               "trk_last_pos", "trk_last_val")
        ins.update(
            tgate=tgate.astype(jnp.int32), trk_v2f_mu=_rows(state.trk_v2f_mu),
            trk_path=_rows(state.trk_path), trk_path_len=state.trk_path_len,
            **{k: _rows(getattr(state, k)) for k in trk},
        )
        outputs += list(trk)
    if not outputs:
        return {}
    cfg["outputs"] = tuple(outputs)
    out = _call(_factor_kernel, cfg, ins, interpret=interpret)
    return {k: x.reshape(getattr(state, k).shape) for k, x in out.items()}


def belief_pass(state, params, gate, *, responses: bool, interpret=False) -> dict:
    """Belief update of every variable where `gate` ([R] bool) holds
    (variables.sum_messages + update_beliefs); with `responses`, also the
    snapshots and the internal-factor responses of
    tick.internal_variable_pass."""
    R, V = state.prior_mean.shape[:2]
    outputs = ["belief_eta", "belief_lam", "belief_mean"]
    cfg = _cfg(params, R, responses=responses)
    ins = {
        "gate": gate.astype(jnp.int32),
        "prior_mean": _rows(state.prior_mean),
        "prior_sigma": _rows(state.prior_sigma),
        "dyn_f2v_eta": _rows(state.dyn_f2v_eta),
        "dyn_f2v_lam": _rows(state.dyn_f2v_lam),
        "ext_sum": _rows(rank1_sum_compact(state.ext_inbox, axis=1)),
        **{k: _rows(getattr(state, k)) for k in outputs},
    }
    if V > 2:
        ins.update({k: _rows(getattr(state, k)) for k in (
            "obs_f2v_eta", "obs_f2v_lam", "trk_f2v_eta", "trk_f2v_lam")})
    if responses:
        outputs += ["snap_eta", "snap_lam", "snap_mu"]
        if cfg["dynamic"]:
            outputs += ["dyn_v2f_eta", "dyn_v2f_lam", "dyn_v2f_mu"]
        if cfg["obstacle"]:
            outputs.append("obs_v2f_mu")
        if cfg["tracking"]:
            outputs.append("trk_v2f_mu")
        ins.update({k: _rows(getattr(state, k)) for k in outputs if k not in ins})
    cfg["outputs"] = tuple(outputs)
    out = _call(_belief_kernel, cfg, ins, interpret=interpret)
    return {k: x.reshape(getattr(state, k).shape) for k, x in out.items()}
