"""Batched small-matrix linear algebra for the GBP core.

DOFS = 4 and factors have at most two neighbours, so all inverses are
batched 4x4 and the Schur-complement
marginalization (reference: crates/magics/src/factorgraph/factor/
marginalise_factor_distance.rs:55-127) specialises to closed-form block ops on
`[..., 4, 4]` tensors — no dynamic matrix partitioning, no LAPACK calls, just
elementwise math and tiny matmuls that XLA fuses into the surrounding kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched tiny matmul [..., n, k] @ [..., k, m] as multiply-reduce.

    Spelled as broadcast-multiply + sum, a k=4 contraction stays an
    elementwise op that fuses with its neighbours, never becomes a batched
    `dot_general` call, and never runs at reduced (TF32) precision.
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def mtm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched a^T @ b for [..., k, n], [..., k, m] -> [..., n, m]."""
    return jnp.sum(a[..., :, :, None] * b[..., :, None, :], axis=-3)


def mv(a: jax.Array, v: jax.Array) -> jax.Array:
    """Batched tiny matvec [..., n, k] @ [..., k] as multiply-reduce."""
    return jnp.sum(a * v[..., None, :], axis=-1)


def inv4(m: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched closed-form inverse of [..., 4, 4] matrices via cofactors.

    Returns (inverse, det). Where det == 0 the inverse contains inf/nan; the
    caller decides how to guard (the reference's `ndarray_inverse::Inverse`
    returns None exactly when det == 0, crates/magics .. variable.rs:278).
    """
    a = m
    # 2x2 sub-determinants of rows 0,1 (c) and rows 2,3 (d)
    c01 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    c02 = a[..., 0, 0] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 0]
    c03 = a[..., 0, 0] * a[..., 1, 3] - a[..., 0, 3] * a[..., 1, 0]
    c12 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c13 = a[..., 0, 1] * a[..., 1, 3] - a[..., 0, 3] * a[..., 1, 1]
    c23 = a[..., 0, 2] * a[..., 1, 3] - a[..., 0, 3] * a[..., 1, 2]

    d01 = a[..., 2, 0] * a[..., 3, 1] - a[..., 2, 1] * a[..., 3, 0]
    d02 = a[..., 2, 0] * a[..., 3, 2] - a[..., 2, 2] * a[..., 3, 0]
    d03 = a[..., 2, 0] * a[..., 3, 3] - a[..., 2, 3] * a[..., 3, 0]
    d12 = a[..., 2, 1] * a[..., 3, 2] - a[..., 2, 2] * a[..., 3, 1]
    d13 = a[..., 2, 1] * a[..., 3, 3] - a[..., 2, 3] * a[..., 3, 1]
    d23 = a[..., 2, 2] * a[..., 3, 3] - a[..., 2, 3] * a[..., 3, 2]

    det = c01 * d23 - c02 * d13 + c03 * d12 + c12 * d03 - c13 * d02 + c23 * d01

    adj = jnp.stack(
        [
            jnp.stack(
                [
                    a[..., 1, 1] * d23 - a[..., 1, 2] * d13 + a[..., 1, 3] * d12,
                    -a[..., 0, 1] * d23 + a[..., 0, 2] * d13 - a[..., 0, 3] * d12,
                    a[..., 3, 1] * c23 - a[..., 3, 2] * c13 + a[..., 3, 3] * c12,
                    -a[..., 2, 1] * c23 + a[..., 2, 2] * c13 - a[..., 2, 3] * c12,
                ],
                axis=-1,
            ),
            jnp.stack(
                [
                    -a[..., 1, 0] * d23 + a[..., 1, 2] * d03 - a[..., 1, 3] * d02,
                    a[..., 0, 0] * d23 - a[..., 0, 2] * d03 + a[..., 0, 3] * d02,
                    -a[..., 3, 0] * c23 + a[..., 3, 2] * c03 - a[..., 3, 3] * c02,
                    a[..., 2, 0] * c23 - a[..., 2, 2] * c03 + a[..., 2, 3] * c02,
                ],
                axis=-1,
            ),
            jnp.stack(
                [
                    a[..., 1, 0] * d13 - a[..., 1, 1] * d03 + a[..., 1, 3] * d01,
                    -a[..., 0, 0] * d13 + a[..., 0, 1] * d03 - a[..., 0, 3] * d01,
                    a[..., 3, 0] * c13 - a[..., 3, 1] * c03 + a[..., 3, 3] * c01,
                    -a[..., 2, 0] * c13 + a[..., 2, 1] * c03 - a[..., 2, 3] * c01,
                ],
                axis=-1,
            ),
            jnp.stack(
                [
                    -a[..., 1, 0] * d12 + a[..., 1, 1] * d02 - a[..., 1, 2] * d01,
                    a[..., 0, 0] * d12 - a[..., 0, 1] * d02 + a[..., 0, 2] * d01,
                    -a[..., 3, 0] * c12 + a[..., 3, 1] * c02 - a[..., 3, 2] * c01,
                    a[..., 2, 0] * c12 - a[..., 2, 1] * c02 + a[..., 2, 2] * c01,
                ],
                axis=-1,
            ),
        ],
        axis=-2,
    )

    inv = adj / det[..., None, None]
    return inv, det


def inv4_rowscaled(m: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Row-equilibrated batched 4x4 inverse.

    The reference pins current/horizon variables with prior precision 1e30
    (robot.rs:1198-1208); det of such a matrix overflows float32 (1e120). We
    scale each row by its max |entry| before the cofactor inverse:
    Lam = D^-1 M with D = diag(1/rowmax), so Lam^-1 = M^-1 D. det(M) is used
    for the singularity check (scale-invariant up to the equilibration).

    Returns (inverse, det_of_scaled_matrix).
    """
    rowmax = jnp.max(jnp.abs(m), axis=-1)  # [..., 4]
    d = jnp.where(rowmax > 0.0, 1.0 / rowmax, 1.0)
    scaled = m * d[..., :, None]
    inv_scaled, det = inv4(scaled)
    inv = inv_scaled * d[..., None, :]
    return inv, det


def belief_covariance(lam: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Invert a belief precision [..., 4, 4] with a residual sanity check.

    The reference treats "inversion failed" (exact-zero determinant) and
    non-finite covariances as "keep the previous mean"
    (variable.rs:276-297). A cofactor inverse of a numerically-singular
    matrix returns huge-but-finite garbage instead of failing, so we also
    validate ||lam @ cov - I||_inf — the multiplicative residual is tiny for
    any meaningfully invertible precision (including the 1e30-pinned
    endpoint priors) and enormous for rank-deficient ones.
    """
    cov, det = inv4_rowscaled(lam)
    eye = jnp.eye(lam.shape[-1], dtype=lam.dtype)
    resid = jnp.max(jnp.abs(mm(lam, cov) - eye), axis=(-2, -1))
    finite = jnp.all(jnp.isfinite(cov), axis=(-2, -1))
    valid = (det != 0.0) & finite & (resid < 1e-4)
    return cov, valid


def marginalize_two_block(
    eta_a: jax.Array,
    eta_b: jax.Array,
    lam_aa: jax.Array,
    lam_ab: jax.Array,
    lam_ba: jax.Array,
    lam_bb: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Schur marginalization of an 8-dof factor potential onto block a.

    eta_* : [..., 4], lam_** : [..., 4, 4].
    Returns (eta_msg, lam_msg, valid). `valid` is False where lam_bb is
    singular or where the marginal precision came out non-finite — the
    reference emits an *empty* message in both situations
    (marginalise_factor_distance.rs:74-127); callers should zero the message
    where ~valid.
    """
    lam_bb_inv, det = inv4_rowscaled(lam_bb)
    lam_ab_bbinv = mm(lam_ab, lam_bb_inv)
    eta_msg = eta_a - mv(lam_ab_bbinv, eta_b)
    lam_msg = lam_aa - mm(lam_ab_bbinv, lam_ba)

    finite = jnp.all(jnp.isfinite(lam_msg), axis=(-2, -1)) & jnp.all(
        jnp.isfinite(eta_msg), axis=-1
    )
    # Magnitude guard: for a PSD joint potential the Schur complement
    # satisfies 0 <= lam_msg <= lam_aa, so a marginal whose entries vastly
    # exceed lam_aa's scale can only be the product of inverting a
    # numerically singular lam_bb — the situation where the reference's
    # exact-zero determinant check returns an empty message
    # (marginalise_factor_distance.rs:74-81). Without this, a variable that
    # has not yet accumulated any precision (start-up, interior priors are
    # zero) poisons its neighbours with huge garbage precision.
    scale_aa = jnp.max(jnp.abs(lam_aa), axis=(-2, -1))
    lam_msg_scale = jnp.max(jnp.abs(lam_msg), axis=(-2, -1))
    sane = lam_msg_scale <= 4.0 * scale_aa + 1.0

    # Cancellation floor: with an *empty* cavity on edge b, the true marginal
    # of a rank-deficient potential (every factor kind: the joint is
    # J^T Lam_m J with <=4 measurement rows over 8 dofs) is exactly zero
    # information, but the Schur subtraction leaves roundoff of order
    # eps * ||lam_aa|| * cond — measured <= 2.1e-6 relative in float32 and
    # 4e-15 in float64 for the dynamic-factor Q. In f64 the reference's
    # downstream "precision not zero" check (any entry > 1e-6,
    # variable.rs:276-284) happens to swallow this noise; in f32 it does not,
    # interior variables turn spuriously "valid" at startup, and tracking
    # factors then linearise at garbage means (observed as a 500 m/s velocity
    # explosion in the Solo GP scenario). A message whose precision is below
    # rtol of the potential's own block scale carries no information — emit
    # it empty, exactly like the reference's singular-marginal path.
    rtol = 1e-4 if lam_msg.dtype == jnp.float32 else 1e-12
    negligible = lam_msg_scale <= rtol * scale_aa
    # Scale-invariant singularity test: `det` comes from the row-equilibrated
    # matrix, so it approximates the product of relative singular values. A
    # numerically rank-deficient lam_bb (e.g. a rank-1 inter-robot potential
    # plus a not-yet-converged belief with ~1e-13 precision) must produce an
    # *empty* message — the Schur complement of such a cavity is pure noise,
    # and the correct limit (pseudo-inverse of the zero-information direction)
    # is zero information. The threshold also bounds the noise amplification
    # of the Schur inverse to ~1e6 x roundoff; messages near the threshold
    # carry information proportional to the cavity's (negligible) precision,
    # so discarding them loses nothing. The reference reaches the same outcome via its
    # det == 0.0 check whenever its pure-Rust determinant cancels exactly.
    valid = (jnp.abs(det) > 1e-6) & finite & sane & ~negligible

    ok = valid[..., None]
    eta_msg = jnp.where(ok, eta_msg, 0.0)
    lam_msg = jnp.where(ok[..., None], lam_msg, 0.0)
    return eta_msg, lam_msg, valid
