"""Eigensolver tests: CheFSI and subspace iteration vs scipy ARPACK oracles
(residual-norm checked, not bitwise -- SURVEY.md section 4)."""

import numpy as np
import jax.numpy as jnp

from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.dirac import gamma3_pair, pair_operator
from deflatedmlmc_schwinger_tpu.solvers.eigs import (
    chebyshev_filtered_smallest,
    inverse_iteration_smallest,
    subspace_iteration_largest,
)


def dense_pair_matvec(A):
    Ap = cplx.from_complex(np.asarray(A, dtype=complex))
    return lambda v: cplx.matmul_right(v, Ap)


def test_chefsi_smallest_Q(op16):
    op, A = op16
    pop = pair_operator(op)
    mvQ = lambda v: gamma3_pair(pop.matvec(v))
    res = chebyshev_filtered_smallest(
        mvQ, op.n, 4, rdtype=jnp.float64, seed=0, degree=150, rounds=10
    )
    from scipy.sparse.linalg import eigsh

    half = A.shape[0] // 2
    Q = A.tolil(copy=True)
    Q[half:, :] = -Q[half:, :]
    ev = eigsh(Q.tocsc(), k=4, sigma=0, which="LM", return_eigenvectors=False)
    np.testing.assert_allclose(
        np.sort(np.abs(res.values)), np.sort(np.abs(ev)), rtol=1e-4
    )
    assert (res.resnorms < 5e-3).all()


def test_subspace_iteration_largest_dense():
    rng = np.random.default_rng(0)
    n = 60
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (M + M.conj().T) / 2
    res = subspace_iteration_largest(
        dense_pair_matvec(H), n, 4, rdtype=jnp.float64, seed=1, rounds=40, buffer=10
    )
    ev = np.linalg.eigvalsh(H)
    want = np.sort(np.abs(ev))[-4:]
    np.testing.assert_allclose(np.sort(np.abs(res.values)), want, rtol=1e-4)


def test_subspace_iteration_largest_clustered_pm_pairs():
    """Indefinite spectrum with near-degenerate +/- pairs at the top -- the
    MLMC difference operator's shape (plain
    block power iteration can stall on clustered +/- lambda).  The top
    cluster is {+5, -5, +4.995, -4.995}: power iteration cannot separate the
    pair magnitudes, so convergence must come from the Rayleigh--Ritz
    extraction over a buffered subspace."""
    rng = np.random.default_rng(7)
    n = 80
    lam = np.concatenate(
        [[5.0, -5.0, 4.995, -4.995, 3.0, -3.0], rng.uniform(-1.0, 1.0, n - 6)]
    )
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    U, _ = np.linalg.qr(M)
    H = (U * lam[None, :]) @ U.conj().T
    H = (H + H.conj().T) / 2
    res = subspace_iteration_largest(
        dense_pair_matvec(H), n, 4, rdtype=jnp.float64, seed=3, rounds=60,
        buffer=10, tol=1e-3,
    )
    want = np.sort(np.abs(lam))[-4:]
    np.testing.assert_allclose(np.sort(np.abs(res.values)), want, rtol=1e-3)
    # signs of the +/- pair must both be recovered (not a doubled +lambda)
    top = np.sort(res.values[np.argsort(-np.abs(res.values))[:2]])
    assert top[0] < 0 < top[1]
    assert (res.resnorms < 1e-1).all()  # reference-loose acceptance


def test_inverse_iteration_smallest_dense():
    rng = np.random.default_rng(2)
    n = 50
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (M + M.conj().T) / 2 + 0.1 * np.eye(n)
    Hinv = np.linalg.inv(H)
    res = inverse_iteration_smallest(
        dense_pair_matvec(H),
        dense_pair_matvec(Hinv),
        n,
        3,
        rdtype=jnp.float64,
        seed=3,
        rounds=15,
    )
    ev = np.linalg.eigvalsh(H)
    want = np.sort(np.abs(ev))[:3]
    np.testing.assert_allclose(np.sort(np.abs(res.values)), want, rtol=1e-8)
    assert (res.resnorms < 1e-5).all()


def test_inverse_iteration_smallest_device_matches_host():
    """Device-resident inverse iteration (k x k host traffic only) recovers
    the same smallest eigenvalues as the host twin and the dense oracle."""
    from deflatedmlmc_schwinger_tpu.solvers.eigs import (
        inverse_iteration_smallest_device,
    )

    rng = np.random.default_rng(4)
    n = 50
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (M + M.conj().T) / 2 + 0.1 * np.eye(n)
    Hinv = np.linalg.inv(H)
    res = inverse_iteration_smallest_device(
        dense_pair_matvec(H),
        dense_pair_matvec(Hinv),
        n,
        3,
        rdtype=jnp.float64,
        seed=3,
        rounds=15,
    )
    ev = np.linalg.eigvalsh(H)
    want = np.sort(np.abs(ev))[:3]
    np.testing.assert_allclose(np.sort(np.abs(res.values)), want, rtol=1e-8)
    assert (res.resnorms < 1e-5).all()
    # vectors are device (k, n) rows with unit norm
    assert res.vectors.re.shape == (3, n)
    nrm = np.asarray(cplx.norm2(res.vectors))
    np.testing.assert_allclose(nrm, 1.0, rtol=1e-10)
