"""Bound the trace bias introduced by the float32 solve-tolerance floor.

The reference solves probe systems at function_tol=1e-12 (reference:
gateway.py:14,56); in complex64 the residual floor clips that to
~3e-7 (SolverConfig.tol_floor_c64) and the stagnation cutoff exits around
~5e-4 on ill-conditioned batches. Solver error at those tolerances enters the
per-probe estimates; the STATISTICAL part is absorbed by the stopping rule
(it inflates the sample variance), but any systematic part would bias the
trace. This test measures that bias directly on 16^2: the SAME counter-keyed
probe stream is solved in f32 (floor tolerances) and in f64 at 1e-13 (the
oracle), so the difference of the per-probe estimates is pure solver /
precision error with zero statistical noise.

Bounds asserted below (the 1% trace budget is 1e-2):
  f32 @ 3e-7 floor:  |mean diff| < 1e-3 of |trace|
  f32 @ 5e-4 stall:  |mean diff| < 5e-3 of |trace|
"""

import numpy as np
import jax.numpy as jnp
import pytest

from deflatedmlmc_schwinger_tpu.config import SolverConfig, TraceConfig
from deflatedmlmc_schwinger_tpu.io import load_operator
from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16

B = 32


def _cfg(dtype):
    return TraceConfig(
        matrix=SPEC16,
        mass=MASS16,
        latt_dims=(16, 16),
        max_nr_levels=3,
        aggrs=(4, 4),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        chebyshev_degree=50,
        subspace_iters=4,
        dtype=dtype,
    )


def _estimates(np_dtype, cfg, tol):
    """Per-probe Hutchinson estimates <x, A^{-1} x> for the fixed probe
    stream, solved at ``tol`` (clipped by the dtype floor)."""
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=np_dtype)
    hier = setup_hierarchy(op, cfg)
    solver = MGSolver(hier, cfg.solver)
    rdt = hier.levels[0].op.dtype
    probes = make_probe_source("jax", 4242)
    X = probes(0, B, op.n, rdt)
    res = solver.solve(X, tol)
    relres = np.asarray(res.resnorm / res.bnorm)
    e = cplx.cdot(X, res.x)
    return np.asarray(e.re).astype(np.float64) + 1j * np.asarray(e.im), relres


@pytest.fixture(scope="module")
def oracle64(exact16):
    es, relres = _estimates(np.complex128, _cfg(jnp.complex128), 1e-13)
    assert relres.max() < 1e-10
    # sanity: the probe mean is a plausible draw around the exact trace
    assert abs(es.mean() - exact16) < 5 * es.std() / np.sqrt(B)
    return es


def test_f32_floor_bias_below_trace_budget(oracle64, exact16):
    """function_tol=1e-12 clipped to the c64 floor (3e-7)."""
    es32, relres = _estimates(np.complex64, _cfg(jnp.complex64), 1e-12)
    cfg = _cfg(jnp.complex64)
    assert cfg.solver.effective_tol(1e-12, jnp.complex64) == cfg.solver.tol_floor_c64
    diff = es32 - oracle64
    rel_bias = abs(diff.mean()) / abs(exact16)
    # 1% is the trace budget; the floor must contribute well under it
    assert rel_bias < 1e-3, (rel_bias, relres.max())


def test_f32_stall_tolerance_bias_below_trace_budget(oracle64, exact16):
    """The loose 5e-4 tolerance (the stagnation-exit regime used by the
    throughput benchmark) still biases the trace well under the 1% budget."""
    es32, relres = _estimates(np.complex64, _cfg(jnp.complex64), 5e-4)
    diff = es32 - oracle64
    rel_bias = abs(diff.mean()) / abs(exact16)
    assert rel_bias < 5e-3, (rel_bias, relres.max())


def test_stalled_flag_reports_unconverged_rows():
    """Rows that cannot reach the requested tolerance are flagged, not
    silently returned (ADVICE round 1: nothing checked final_res)."""
    from deflatedmlmc_schwinger_tpu.solvers.fgmres import fgmres

    cfg = _cfg(jnp.complex64)
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=np.complex64)
    hier = setup_hierarchy(op, cfg)
    solver = MGSolver(hier, cfg.solver)
    probes = make_probe_source("jax", 7)
    X = probes(0, 4, op.n, hier.levels[0].op.dtype)
    # unpreconditioned + absurdly tight f32 tolerance + tiny budget -> stall
    res = fgmres(solver.matvec(0), X, tol=1e-12, restart=10, max_restarts=3)
    assert bool(np.all(np.asarray(res.stalled)))
    # preconditioned solve at an attainable tolerance -> no stall
    res2 = solver.solve(X, 1e-4)
    assert not bool(np.any(np.asarray(res2.stalled)))
