"""Information-form multivariate Gaussian (gbp_multivariate_normal parity).

Reference: crates/gbp_multivariate_normal/src/lib.rs:38-210 — a Gaussian
stored as (information vector eta, precision matrix Lambda) with a cached
mean, constructible from either parameterisation, with product/division by
information addition/subtraction. The GBP hot path does NOT use this type
(it inlines eta/Lambda fields, like the reference's factorgraph does); it
exists as the user-facing numerics API.

Batched: eta [..., D], lam [..., D, D]; all ops broadcast over leading axes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from magics_tpu.core.linalg import mv


class NotPositiveSemiDefinite(ValueError):
    """Raised when a precision/covariance matrix is not invertible PSD
    (lib.rs error enum)."""


def _inv(m: jax.Array) -> jax.Array:
    inv = jnp.linalg.inv(m)
    if not bool(jnp.all(jnp.isfinite(inv))):
        raise NotPositiveSemiDefinite("matrix is singular")
    return inv


@dataclasses.dataclass(frozen=True)
class MultivariateNormal:
    """N(mu, Sigma) stored as (eta = Lambda mu, Lambda = Sigma^-1)."""

    eta: jax.Array  # [..., D]
    lam: jax.Array  # [..., D, D]

    # -- constructors (lib.rs:63-160) -----------------------------------

    @classmethod
    def from_information_and_precision(cls, eta, lam) -> "MultivariateNormal":
        eta = jnp.asarray(eta)
        lam = jnp.asarray(lam)
        _inv(lam)  # validate invertibility like the reference constructor
        return cls(eta=eta, lam=lam)

    @classmethod
    def from_mean_and_covariance(cls, mean, cov) -> "MultivariateNormal":
        mean = jnp.asarray(mean)
        cov = jnp.asarray(cov)
        lam = _inv(cov)
        eta = mv(lam, mean)
        return cls(eta=eta, lam=lam)

    @classmethod
    def from_mean_and_precision(cls, mean, lam) -> "MultivariateNormal":
        mean = jnp.asarray(mean)
        lam = jnp.asarray(lam)
        _inv(lam)
        eta = mv(lam, mean)
        return cls(eta=eta, lam=lam)

    # -- accessors (lib.rs:168-210) -------------------------------------

    @property
    def dims(self) -> int:
        return self.eta.shape[-1]

    def mean(self) -> jax.Array:
        return mv(_inv(self.lam), self.eta)

    def covariance(self) -> jax.Array:
        return _inv(self.lam)

    def information_vector(self) -> jax.Array:
        return self.eta

    def precision_matrix(self) -> jax.Array:
        return self.lam

    # -- algebra: product/quotient of Gaussians = info add/subtract ------

    def __mul__(self, other: "MultivariateNormal") -> "MultivariateNormal":
        return MultivariateNormal(self.eta + other.eta, self.lam + other.lam)

    def __truediv__(self, other: "MultivariateNormal") -> "MultivariateNormal":
        return MultivariateNormal(self.eta - other.eta, self.lam - other.lam)

    def add_assign_information(self, eta, lam) -> "MultivariateNormal":
        return MultivariateNormal(self.eta + eta, self.lam + lam)
