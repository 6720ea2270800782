"""Displaced-trace (permuted observable) machinery tests.

The permuted MLMC telescoping identity is verified DENSELY -- a rigorous,
sampling-free check that the B-block operators, per-level shifts, and the
coarsest permuted trace (reference: multigrid.py:141-155,318-331,
stoch_trace.py:431-435) compose to an unbiased estimator of
tr(A^{-1} Pi^T):

  sum_l tr((A_l^{-1} - P_l A_{l+1}^{-1} R_l) B_l Pi_l^T)
      + tr(A_c^{-1} B_c Pi_c^T)  ==  tr(A_0^{-1} Pi_0^T).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy
from deflatedmlmc_schwinger_tpu.trace.mlmc import bblock_matrix
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16


def cfgp(**kw):
    base = dict(
        matrix=SPEC16,
        mass=MASS16,
        latt_dims=(16, 16),
        max_nr_levels=3,
        aggrs=(4, 4),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=True,
        x_displacement=2,
        chebyshev_degree=40,
        subspace_iters=3,
    )
    base.update(kw)
    return TraceConfig(**base)


@pytest.fixture(scope="module")
def phier(op16):
    op, A = op16
    cfg = cfgp()
    return op, A, cfg, setup_hierarchy(op, cfg)


def _perm_matrix(n, d):
    """Pi as a dense matrix ((Pi x)[i] = x[(i+d)%n]), matching the reference's
    Pperm construction (multigrid.py:151-153)."""
    diagonals = [np.ones(n - d), np.ones(d)]
    return np.asarray(sp.diags(diagonals, [-d, n - d]).transpose().todense())


def test_perm_shifts_propagate(phier):
    op, A, cfg, hier = phier
    # d0 = nt*ndof*x_disp (multigrid.py:148-150); coarse: (d/L)*dof[i+1]
    assert hier.levels[0].perm_shift == 16 * 2 * 2
    assert hier.levels[1].perm_shift == (64 // 8) * 4
    assert hier.levels[2].perm_shift == (32 // 16) * 4


def test_bblock_level1_matches_definition(phier):
    op, A, cfg, hier = phier
    P0 = hier.levels[0].P.to_dense()
    Pi0 = _perm_matrix(hier.levels[0].n, hier.levels[0].perm_shift)
    Pi1 = _perm_matrix(hier.levels[1].n, hier.levels[1].perm_shift)
    # reference: B1 = (R0 B0) (Pi0^H P0 Pi1)  (multigrid.py:328-331)
    B1_ref = P0.conj().T @ Pi0.conj().T @ P0 @ Pi1
    B1 = bblock_matrix(hier, 1)
    np.testing.assert_allclose(B1, B1_ref, atol=1e-12)


def test_permuted_telescoping_identity(phier):
    op, A, cfg, hier = phier
    Ad = np.asarray(A.todense())
    mats = [Ad] + [l.op.complex_matrix() for l in hier.levels[1:]]
    invs = [np.linalg.inv(m) for m in mats]
    Ps = [l.P.to_dense() for l in hier.levels[:-1]]
    Pis = [_perm_matrix(l.n, l.perm_shift) for l in hier.levels]
    Bs = [np.eye(hier.levels[0].n)] + [bblock_matrix(hier, i) for i in (1, 2)]
    total = 0.0 + 0.0j
    for i in range(2):
        Mi = invs[i] - Ps[i] @ invs[i + 1] @ Ps[i].conj().T
        total += np.trace(Mi @ Bs[i] @ Pis[i].T)
    total += np.trace(invs[2] @ Bs[2] @ Pis[2].T)
    exact = np.trace(invs[0] @ Pis[0].T)
    assert abs(total - exact) < 1e-9


def test_permuted_telescoping_identity_skip_level(phier):
    """Skip-level composite form (reference: multigrid.py:496-549)."""
    op, A, cfg, hier = phier
    Ad = np.asarray(A.todense())
    A2 = hier.levels[2].op.complex_matrix()
    P0 = hier.levels[0].P.to_dense()
    P1 = hier.levels[1].P.to_dense()
    Pc = P0 @ P1
    Pi0 = _perm_matrix(hier.levels[0].n, hier.levels[0].perm_shift)
    Pi2 = _perm_matrix(hier.levels[2].n, hier.levels[2].perm_shift)
    B2 = np.asarray(bblock_matrix(hier, 2))
    lvl0 = np.trace((np.linalg.inv(Ad) - Pc @ np.linalg.inv(A2) @ Pc.conj().T) @ Pi0.T)
    crst = np.trace(np.linalg.inv(A2) @ B2 @ Pi2.T)
    exact = np.trace(np.linalg.inv(Ad) @ Pi0.T)
    assert abs(lvl0 + crst - exact) < 1e-9


def test_bblock_host_matches_device(phier):
    """bblock_matrix_host (sparse host recursion, used by the exact-level
    and coarsest phases) equals the device bblock operator at every level."""
    from deflatedmlmc_schwinger_tpu.trace.mlmc import bblock_matrix_host

    op, A, cfg, hier = phier
    for level in (1, 2):
        np.testing.assert_allclose(
            bblock_matrix_host(hier, level),
            np.asarray(bblock_matrix(hier, level)),
            atol=1e-10,
        )


def test_exact_difference_trace_permuted(phier):
    """exact_difference_trace (mlmc_exact_dense_max_n path) reproduces the
    dense displaced telescoping term tr((A_l^{-1} - P A_c^{-1} R) B_l Pi_l^T)
    for both the plain and the skip-composite form."""
    from deflatedmlmc_schwinger_tpu.trace.mlmc import exact_difference_trace

    op, A, cfg, hier = phier
    Ad = np.asarray(A.todense())
    mats = [Ad] + [l.op.complex_matrix() for l in hier.levels[1:]]
    invs = [np.linalg.inv(m) for m in mats]
    Ps = [l.P.to_dense() for l in hier.levels[:-1]]
    Pis = [_perm_matrix(l.n, l.perm_shift) for l in hier.levels]
    Bs = [np.eye(hier.levels[0].n)] + [bblock_matrix(hier, i) for i in (1, 2)]
    # plain level-1 term
    M1 = invs[1] - Ps[1] @ invs[2] @ Ps[1].conj().T
    want1 = np.trace(M1 @ Bs[1] @ Pis[1].T)
    got1 = exact_difference_trace(hier, 1, False, True)
    assert abs(got1 - want1) < 1e-8 * max(abs(want1), 1)
    # skip-composite level-0 term (coarse = level 2, P = P0 P1)
    Pc = Ps[0] @ Ps[1]
    M0 = invs[0] - Pc @ invs[2] @ Pc.conj().T
    want0 = np.trace(M0 @ Bs[0] @ Pis[0].T)
    got0 = exact_difference_trace(hier, 0, True, True)
    assert abs(got0 - want0) < 1e-8 * max(abs(want0), 1)


def test_coarsest_permuted_trace_matches_reference_form(phier):
    """jnp.roll-based Pi_c^T application == dense Pperm matrix product."""
    op, A, cfg, hier = phier
    from deflatedmlmc_schwinger_tpu.ops import cplx
    M = cplx.to_complex(hier.coarsest_inv) @ bblock_matrix(hier, 2)
    d = hier.levels[2].perm_shift
    Pic = _perm_matrix(hier.levels[2].n, d)
    want = np.trace(Pic.T @ M)
    got = np.trace(np.roll(M, d, axis=0))
    assert abs(want - got) < 1e-10
