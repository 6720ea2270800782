"""Matched-seed parity against the actual reference code ("matched-seed
numerical agreement with the NumPy/SciPy reference ... at equal or lower
per-sample variance").

These tests import the reference from /root/reference through the shims in
tests/refharness.py (pure-Python fgmres for pyamg, lgmres tol->rtol) and
compare PER-PROBE estimates on the exact same NumPy Rademacher stream:

  * Hutchinson (undeflated): identical probes + identical operator + both
    solves at 1e-12 => per-probe estimates must agree to solver tolerance.
  * Hutchinson (deflated, equal k): both deflation bases converge to the
    same gamma3-eigenspace, so projectors, tr1, per-probe estimates, and
    per-sample variance must all match -- the variance clause of the north
    star is checked as ours <= reference * (1 + eps).
  * MLMC difference levels: per-level traces are hierarchy-specific
    (SURVEY.md section 4), so the REFERENCE's own hierarchy is imported into
    our MGSolver (tests/refharness.import_hierarchy) and the per-probe
    difference estimates must agree.

Skipped when /root/reference is not present.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import refharness as rh

pytestmark = pytest.mark.skipif(
    not rh.reference_available(), reason="/root/reference not available"
)

MASS16 = -1.00690114 * 0.99


@pytest.fixture(scope="module")
def ref16():
    """Reference matrix + MG hierarchy at 16^2 (repaired params)."""
    A = rh.load_matrix("schwinger16.mat", MASS16)
    params = rh.params_16(function_tol=1e-12)
    mg = rh.build_mg(A, params)
    return A, params, mg


@pytest.fixture(scope="module")
def ours16(op16):
    from deflatedmlmc_schwinger_tpu.config import TraceConfig
    from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator

    op, A = op16
    cfg = TraceConfig(
        matrix="schwinger16.mat",
        mass=MASS16,
        latt_dims=(16, 16),
        max_nr_levels=3,
        aggrs=(4, 4),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        function_tol=1e-12,
        nr_deflat_vctrs=8,
        defl_eigvs_tol_Hutch=1e-9,
        # parity needs the SAME subspace as ARPACK@1e-9: generous guard
        # buffer + rounds so the window-edge Ritz pairs converge too
        defl_buffer=24,
        defl_subspace_rounds=40,
        chebyshev_degree=50,
        subspace_iters=4,
        probe_batch=8,
        mlmc_levels_to_skip=(),
    )
    hier = setup_hierarchy(op, cfg)
    return pair_operator(op), cfg, MGSolver(hier, cfg.solver)


def _our_hutch_estimates(op, solver, cfg, defl, nprobes, seed):
    from deflatedmlmc_schwinger_tpu.trace.hutchinson import hutchinson_step_batch
    from deflatedmlmc_schwinger_tpu.trace.probes import make_probe_source

    probes = make_probe_source("numpy", seed)
    X = probes(0, nprobes, op.n, op.dtype)
    es, _, _ = hutchinson_step_batch(op, solver, cfg, defl, X)
    return np.asarray(es)


def test_hutchinson_matched_seed_undeflated(ref16, ours16):
    """Per-probe agreement on the exact reference probe stream, no
    deflation: both sides compute e_i = <x_i, A^{-1} x_i> at 1e-12."""
    from deflatedmlmc_schwinger_tpu.trace.deflation import Deflation

    A, params, mg = ref16
    op, cfg, solver = ours16
    seed, nprobes = 20250821, 8
    es_ref, _ = rh.hutch_probes(mg, A, params, nprobes, seed, k=0)
    es_ours = _our_hutch_estimates(
        op, solver, cfg, Deflation(U=None, tr1=0.0 + 0.0j), nprobes, seed
    )
    scale = np.abs(es_ref).max()
    diff = np.abs(es_ours - es_ref).max()
    assert diff < 1e-6 * scale, (diff, scale, es_ours[:3], es_ref[:3])


def test_hutchinson_matched_seed_deflated_and_variance(ref16, ours16):
    """Equal-k deflated runs on the matched stream: per-probe agreement,
    tr1 agreement, and the north star's per-sample variance clause
    (ours <= reference, up to f64 roundoff slack)."""
    A, params, mg = ref16
    op, cfg, solver = ours16
    ref = rh.load_reference()
    k = int(cfg.nr_deflat_vctrs)

    p = dict(params)
    p["nr_deflat_vctrs"] = k
    Vx, tr1_ref = ref["utils"].deflation_pre_computations(
        A, k, 1e-9, "hutchinson", mg.timer, p, mg
    )

    from deflatedmlmc_schwinger_tpu.trace.deflation import hutchinson_deflation

    defl = hutchinson_deflation(op, solver, cfg)
    assert abs(defl.tr1 - tr1_ref) < 1e-5 * abs(tr1_ref), (defl.tr1, tr1_ref)

    # same deflation subspace: principal angles between span(U_ours) and
    # span(Vx) (the reference's projector basis) are ~0
    U = np.asarray(defl.U.re) + 1j * np.asarray(defl.U.im)   # (n, k)
    Q1, _ = np.linalg.qr(U)
    Q2, _ = np.linalg.qr(Vx)
    s = np.linalg.svd(Q1.conj().T @ Q2, compute_uv=False)
    assert s.min() > 1 - 1e-8, s.min()

    seed, nprobes = 424242, 8
    es_ref, _ = rh.hutch_probes(mg, A, p, nprobes, seed, Vx=Vx, k=k)
    es_ours = _our_hutch_estimates(op, solver, cfg, defl, nprobes, seed)
    scale = max(np.abs(es_ref).max(), 1.0)
    assert np.abs(es_ours - es_ref).max() < 1e-5 * scale

    var_ref = np.var(es_ref)
    var_ours = np.var(es_ours)
    assert var_ours <= var_ref * (1 + 1e-6), (var_ours, var_ref)


def test_mlmc_matched_seed_levels(ref16, ours16):
    """Per-probe MLMC difference-level estimates on the REFERENCE's own
    hierarchy (imported into our solver): level traces are
    hierarchy-specific, so this is the only form of per-level matched-seed
    parity that is well-defined."""
    from deflatedmlmc_schwinger_tpu.config import SolverConfig
    from deflatedmlmc_schwinger_tpu.mg import MGSolver
    from deflatedmlmc_schwinger_tpu.trace.deflation import Deflation
    from deflatedmlmc_schwinger_tpu.trace.mlmc import mlmc_step_batch
    from deflatedmlmc_schwinger_tpu.trace.probes import make_probe_source

    A, params, mg = ref16
    op, cfg, _ = ours16
    hier_imp = rh.import_hierarchy(mg, op, op.dtype)
    solver_imp = MGSolver(hier_imp, SolverConfig())
    nprobes = 6
    for level, seed in ((0, 777001), (1, 777002)):
        es_ref = rh.mlmc_probes(mg, params, level, nprobes, seed)
        probes = make_probe_source("numpy", seed)
        n_l = hier_imp.levels[level].n
        X = probes(0, nprobes, n_l, hier_imp.levels[level].op.dtype)
        es, _, _, _, _ = mlmc_step_batch(
            solver_imp, cfg, level, Deflation(U=None, tr1=0.0 + 0.0j), X,
            skip_level=False,
        )
        es_ours = np.asarray(es)
        scale = max(np.abs(es_ref).max(), 1.0)
        diff = np.abs(es_ours - es_ref).max()
        assert diff < 1e-6 * scale, (level, diff, es_ours[:3], es_ref[:3])
