"""Pinned operators and exact traces for the 16^2 and 128^2 Schwinger configs.

Both operators are generated quenched U(1) configurations (io/gauge.py) at
the reference's mass rule m = 0.99 * m_crit, where m_crit = -min Re lambda(S)
of the massless operator S: the smallest real part of the spectrum of
D = S + m I then sits 1% of |m_crit| above zero.

Recompute every pinned value (about 20 minutes on two CPU cores: ~11 for
ARPACK's 128^2 eigenvalues, ~7.5 for the 128^2 column solves):

    python -c "from deflatedmlmc_schwinger_tpu import oracles; print(oracles.recompute())"
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# 16^2 (G101/G201): beta and seed chosen so that m_crit, the trace and
# min |lambda(D)| ~ 1e-2 match the conditioning of the reference's 16^2 set.
# Its dense oracle (n=512) is cheap and is computed where it is needed.
BETA16, SEED16 = 0.5, 8
M_CRIT16 = -0.9668466739199182
MASS16 = 0.99 * M_CRIT16

# 128^2 (G102/G202): displaced trace tr(D^-1 Pi^T) at x_displacement 2,
# (Pi v)[i] = v[(i + d) % n] with d = 2 * nt * x_displacement (mg/setup.py).
# Method: complex128 sparse LU (scipy splu) solved against all n unit columns.
BETA128, SEED128 = 5.0, 8
X_DISP128 = 2
M_CRIT128 = -0.19111140854905506
MASS128 = 0.99 * M_CRIT128
TRACE128 = -11.081145421402962 - 20.12652912942848j


def spec(nx: int, nt: int, beta: float, seed: int) -> str:
    """The ``TraceConfig.matrix`` string of a generated operator."""
    return f"generated:{nx}x{nt}:beta={beta}:seed={seed}"


SPEC16 = spec(16, 16, BETA16, SEED16)
SPEC128 = spec(128, 128, BETA128, SEED128)


def operator_csr(nx: int, nt: int, beta: float, seed: int,
                 mass: float = 0.0) -> sp.csr_matrix:
    """Complex128 CSR matrix of the generated operator D = S + mass I."""
    from deflatedmlmc_schwinger_tpu.io.gauge import generate_operator
    from deflatedmlmc_schwinger_tpu.io.stencil import csr_from_stencil

    op = generate_operator(nx, nt, mass, beta=beta, seed=seed)
    return csr_from_stencil(np.asarray(op.coeffs, dtype=np.complex128))


def critical_mass(nx: int, nt: int, beta: float, seed: int) -> float:
    """m_crit = -min Re lambda(S): dense eigenvalues up to n = 4096, ARPACK's
    smallest-real-part mode (deterministic start vector) above."""
    S = operator_csr(nx, nt, beta, seed)
    if S.shape[0] <= 4096:
        lam = np.linalg.eigvals(S.toarray())
    else:
        from scipy.sparse.linalg import eigs

        v0 = np.random.default_rng(0).standard_normal(S.shape[0]) + 0j
        lam = eigs(S, k=6, which="SR", v0=v0, return_eigenvectors=False)
    return float(-np.min(lam.real))


def exact_displaced_trace(nx: int, nt: int, beta: float, seed: int,
                          mass: float, x_displacement: int,
                          block: int = 1024) -> complex:
    """tr(D^-1 Pi^T) = sum_j (D^-1)[j, (j + d) % n] in complex128, from a
    sparse LU solved against the unit columns in blocks of ``block``."""
    from scipy.sparse.linalg import splu

    D = operator_csr(nx, nt, beta, seed, mass).tocsc()
    n = D.shape[0]
    d = 2 * nt * x_displacement
    lu = splu(D)
    total = 0.0 + 0.0j
    for c0 in range(0, n, block):
        cols = np.arange(c0, min(c0 + block, n))
        E = np.zeros((n, cols.size), dtype=np.complex128)
        E[cols, np.arange(cols.size)] = 1.0
        X = lu.solve(E)
        total += np.sum(X[(cols - d) % n, np.arange(cols.size)])
    return complex(total)


def recompute() -> dict:
    """Recompute every pinned value above."""
    mc16 = critical_mass(16, 16, BETA16, SEED16)
    mc128 = critical_mass(128, 128, BETA128, SEED128)
    tr128 = exact_displaced_trace(128, 128, BETA128, SEED128, 0.99 * mc128,
                                  X_DISP128)
    return dict(M_CRIT16=mc16, M_CRIT128=mc128, TRACE128=tr128)
