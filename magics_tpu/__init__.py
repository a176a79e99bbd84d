"""magics_tpu — a multi-robot GBP trajectory-optimization engine in JAX.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of the
AU-Master-Thesis/magics reference (Rust/Bevy, gbpplanner algorithm): thousands
of robots each planning over a receding horizon with Gaussian Belief
Propagation on a factor graph (dynamics, SDF obstacle, inter-robot collision
and path-tracking factors), communicating within a comms radius with
stochastic failure.

Instead of one heap-allocated factor graph per robot iterated on CPU threads
(reference: crates/magics/src/factorgraph/), all robots' variable chains are
flattened into dense batched tensors `[R, V, 4]` so factor linearization,
information-form Gaussian products and Schur marginalization run as fused
batched XLA/Pallas ops, and robots shard over a `jax.sharding.Mesh` axis with
inter-robot messages exchanged via XLA collectives.
"""

__version__ = "0.1.0"

from magics_tpu.core.constants import DOFS

__all__ = ["DOFS", "__version__"]
