"""f64 host-residual iterative refinement of the deflation-correction solves
(config.py defl_refine_steps; trace/deflation.py solve_refined_host).

The correction right-hand sides are the deflation vectors -- the most
ill-conditioned systems of the run. In f32 a solve at relative residual r
leaves a SOLUTION error up to ~r/sigma_min per vector, which summed over the
basis can bias tr1. Provenance of the measured bias: the ~+0.5 shift of the
128^2 flagship trace was observed with the pre-r3 Givens-ESTIMATE FGMRES
exits, whose true relative residual was only ~1e-2; with true-residual
termination an honest 5e-4 solve leaves the unrefined correction accurate
(refinement moved the flagship trace by <1e-3, so the tuned configs ship
refinement OFF -- config.py defl_refine_steps). Refinement with exact f64
host residuals collapses the worst case to O(r^2/sigma_min) and remains
available for tighter contracts or looser solve targets.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.io import load_operator
from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.dirac import (
    pair_operator,
    stencil_matvec,
    stencil_matvec_host,
)
from deflatedmlmc_schwinger_tpu.trace.deflation import hutchinson_deflation
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16


def test_host_stencil_matches_device(op16):
    """stencil_matvec_host is an exact (f64) twin of the device stencil."""
    op, A = op16
    rng = np.random.default_rng(3)
    v = rng.standard_normal((4, op.n)) + 1j * rng.standard_normal((4, op.n))
    C = np.asarray(op.coeffs)
    want = np.asarray(op.matvec(jnp.asarray(v)))
    got = stencil_matvec_host(C, v, op.nx, op.nt)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.fixture(scope="module")
def f32_setup():
    cfg = TraceConfig(
        matrix=SPEC16,
        mass=MASS16,
        latt_dims=(16, 16),
        max_nr_levels=3,
        aggrs=(4, 4),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        chebyshev_degree=40,
        subspace_iters=3,
        probe_batch=16,
        nr_deflat_vctrs=16,
        defl_eigvs_tol_Hutch=1e-3,
        # f32 pipeline: the solve target sits well above the f32 floor, so
        # the solver converges -- but the correction SOLUTION error is still
        # ~tol/sigma_min per low-mode vector without refinement
        function_tol=1e-4,
        dtype=jnp.complex64,
    )
    opf, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                           dtype=np.complex64)
    hier = setup_hierarchy(opf, cfg)
    pop = pair_operator(opf)
    solver = MGSolver(hier, cfg.solver)
    # dense f64 inverse of the SAME f32-rounded operator (exact oracle for
    # this pipeline's own arithmetic)
    C = np.asarray(opf.coeffs).astype(np.complex128)
    eye = np.eye(pop.n, dtype=np.complex128)
    Ad = stencil_matvec_host(C, eye, opf.nx, opf.nt).T
    return cfg, pop, solver, np.linalg.inv(Ad)


def _tr1_error(cfg, pop, solver, Ainv, steps):
    d = hutchinson_deflation(pop, solver, cfg.replace(defl_refine_steps=steps))
    U = np.asarray(cplx.to_complex(d.U)).astype(np.complex128)
    oracle = complex(np.trace(U.conj().T @ Ainv @ U))
    return abs(d.tr1 - oracle), abs(oracle)

def test_refinement_removes_f32_correction_bias(f32_setup):
    cfg, pop, solver, Ainv = f32_setup
    err0, scale = _tr1_error(cfg, pop, solver, Ainv, steps=0)
    err2, _ = _tr1_error(cfg, pop, solver, Ainv, steps=2)
    # the unrefined f32 correction carries a visible solution-error bias;
    # two refinement steps collapse it by at least an order of magnitude
    assert err2 < max(0.1 * err0, 2e-4 * scale), (err0, err2, scale)
