"""Deflated Hutchinson / multigrid-MLMC stochastic trace estimation for the
2D Schwinger-model Wilson--Dirac operator, in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
research code (Gustavroot/DeflatedMLMC_Schwinger): it computes tr(D^{-1}) --
optionally the displaced trace tr(D^{-1} Pi) -- of the near-critical Wilson-Dirac
operator D = S + m*I via deflated Hutchinson and deflated multigrid multilevel
Monte Carlo, with an aggregation-based algebraic multigrid solver for all linear
systems.

Design (accelerator-first, not a port):
  * The fine-grid operator is a 9-point gauged stencil held as dense complex
    coefficient fields of shape (2, 2, 5, X, T) -- never CSR on device.
  * Prolongators are per-aggregate dense blocks applied with batched einsums,
    coarse operators are dense / block-sparse device matrices.
  * All solves are batched over probes (vmap-free batched Krylov: FGMRES with a
    V-cycle preconditioner, fixed-iteration GMRES smoothing, lax control flow).
  * Eigenproblems (ARPACK in the reference) become Chebyshev-filtered subspace
    iteration / block Lanczos in JAX.
  * Probes use counter-based per-sample PRNG keys so results are independent of
    batch size and mesh sharding; sample statistics reduce with psum.
"""

__version__ = "0.1.0"

from deflatedmlmc_schwinger_tpu.config import SolverConfig, TraceConfig  # noqa: F401
