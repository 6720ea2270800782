"""Oracle tests for the MLMC deflation variants (reference: utils.py:176-189
for the tr1 correction, utils.py:267-276 for the inexact_03 oblique
projector). Round 1 shipped these untested; here each variant is checked
against a dense small-matrix oracle on the 16^2 lattice, and inexact_01
end-to-end against the exact dense trace.

Note on semantics: the reference's inexact_03 is PARTIALLY implemented there
(tr1 hardcoded to zero, so the estimator is biased by the un-compensated
deflated subspace) -- parity means reproducing the projector mechanics, not
trace correctness, so inexact_03 is tested at the projector level only.
"""

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.trace import mlmc
from deflatedmlmc_schwinger_tpu.trace.deflation import mlmc_level_deflation
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16


def cfg16(**kw):
    base = dict(
        matrix=SPEC16,
        mass=MASS16,
        latt_dims=(16, 16),
        max_nr_levels=3,
        aggrs=(4, 4),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        trace_tol=1e-2,
        nr_deflat_vctrs=24,
        mlmc_deflat_vctrs=(8, 0),
        chebyshev_degree=50,
        subspace_iters=4,
        probe_batch=8,
        mlmc_levels_to_skip=(),
    )
    base.update(kw)
    return TraceConfig(**base)


@pytest.fixture(scope="module")
def setup16v(op16):
    op, A = op16
    cfg = cfg16()
    hier = setup_hierarchy(op, cfg)
    solver = MGSolver(hier, cfg.solver)
    Ad = np.asarray(A.todense())
    # dense difference operator f_0 = A0^{-1} - P0 A1^{-1} R0
    P0 = hier.levels[0].P.to_dense()
    A1 = hier.levels[1].op.complex_matrix()
    F = np.linalg.inv(Ad) - P0 @ np.linalg.inv(A1) @ P0.conj().T
    return op, Ad, F, cfg, hier, solver


def test_inexact_01_tr1_matches_dense_oracle(setup16v):
    """inexact_01's correction is tr(V^H f_0 V) with f_0 applied via loose MG
    solves (reference: utils.py:177-183); oracle = the same trace with the
    dense difference operator."""
    op, Ad, F, cfg, hier, solver = setup16v
    cfg1 = cfg.replace(defl_type="inexact_01")
    defl = mlmc_level_deflation(solver, 0, 8, cfg1, skip_level=False)
    V = cplx.to_complex(defl.U)
    oracle = complex(np.trace(V.conj().T @ (F @ V)))
    # inner solves run at diff_lev_op_tol=1e-3 -> relative agreement ~1e-3
    assert abs(defl.tr1 - oracle) < 2e-3 * max(abs(oracle), 1.0), (defl.tr1, oracle)


def test_exact_tr1_close_to_projected_trace(setup16v):
    """defl_type='exact' uses the eigendecomposition formula
    tr(U^H V Lambda) (utils.py:176); for well-converged eigenpairs it agrees
    with the projected dense trace tr(V^H f_0 V)."""
    op, Ad, F, cfg, hier, solver = setup16v
    cfg0 = cfg.replace(defl_type="exact")
    defl = mlmc_level_deflation(solver, 0, 8, cfg0, skip_level=False)
    V = cplx.to_complex(defl.U)
    oracle = complex(np.trace(V.conj().T @ (F @ V)))
    # eigensolver acceptance is loose (defl_eigvs_tol_MLMC=1e-1, as in the
    # reference) -- this checks the formula is wired right, not convergence
    assert abs(defl.tr1 - oracle) < 0.05 * max(abs(oracle), 1.0), (defl.tr1, oracle)


def test_inexact_03_projector_matches_dense_oracle(setup16v):
    """The oblique projector x - V (U^H A V)^{-1} U^H A x
    (utils.py:269-276), with the small inverse precomputed in Deflation."""
    op, Ad, F, cfg, hier, solver = setup16v
    cfg3 = cfg.replace(defl_type="inexact_03")
    defl = mlmc_level_deflation(solver, 0, 8, cfg3, skip_level=False)
    assert defl.tr1 == 0.0 + 0.0j  # reference parity (utils.py:186-187)
    assert defl.proj_B is not None
    V = cplx.to_complex(defl.U)
    U = cplx.to_complex(defl.aux_V)
    Bl_oracle = np.linalg.inv(U.conj().T @ (Ad @ V))
    assert np.max(np.abs(cplx.to_complex(defl.proj_B) - Bl_oracle)) < 1e-8

    # the step-code contraction chain reproduces the dense projector
    rng = np.random.default_rng(3)
    X = np.where(rng.random((4, Ad.shape[0])) < 0.5, -1.0, 1.0).astype(complex)
    Xp = cplx.from_complex(X)
    Af = solver.matvec(0)
    t = cplx.matmul_right_conjT(Af(Xp), defl.aux_V)
    coef = cplx.matmul_right(t, defl.proj_B)
    x_def = cplx.to_complex(Xp - cplx.matmul_right(coef, defl.U))
    oracle = X - (V @ (Bl_oracle @ (U.conj().T @ (Ad @ X.T)))).T
    assert np.max(np.abs(x_def - oracle)) < 1e-8


def test_mlmc_inexact_01_end_to_end(setup16v, exact16):
    """Full MLMC with defl_type='inexact_01' still matches the exact dense
    trace (5-sigma agreement): the orthogonal projector plus the directly
    computed tr(V^H f V) compensation is unbiased up to inner-solve error."""
    op, Ad, F, cfg, hier, solver = setup16v
    cfg1 = cfg.replace(defl_type="inexact_01", mlmc_deflat_vctrs=(8, 8))
    r = mlmc(op, cfg1, hier=hier, verbose=False)
    devs = [
        res["ests_dev"] / max(np.sqrt(res["nr_ests"]), 1) for res in r["results"]
    ]
    stderr = max(np.sqrt(sum(d * d for d in devs)), 1e-12)
    assert abs(r["trace"] - exact16) < 5 * stderr + 0.02 * abs(exact16)
    # the aggregate stderr field matches the per-level combination
    assert abs(r["std_dev"] - stderr) < 1e-12
