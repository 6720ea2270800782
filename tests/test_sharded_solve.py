"""Lattice-sharded production solve (parallel/sharded_solve.py): the FULL
MG-preconditioned batched FGMRES under shard_map on a ('samples', 'x') mesh
equals the replicated solve to solver tolerance, and the estimators are
invariant to the mesh shape (SURVEY.md P1/P3 contracts)."""

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator
from deflatedmlmc_schwinger_tpu.parallel import ShardedMGSolver, make_mesh
from deflatedmlmc_schwinger_tpu.trace import hutchinson, mlmc
from deflatedmlmc_schwinger_tpu.trace.probes import make_probe_source
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
        nr_deflat_vctrs=16,
        mlmc_deflat_vctrs=(0, 0),
        chebyshev_degree=30,
        subspace_iters=3,
        probe_batch=8,
        mlmc_levels_to_skip=(),
    )
    base.update(kw)
    return TraceConfig(**base)


@pytest.fixture(scope="module")
def setup16s(op16):
    op, A = op16
    cfg = cfg16()
    pop = pair_operator(op)
    hier = setup_hierarchy(pop, cfg)
    return pop, cfg, hier


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_sharded_solve_equals_replicated(setup16s, shape):
    """Full V-cycle-preconditioned FGMRES with the fine lattice sharded over
    'x' reproduces the replicated solve: same iteration counts, solutions
    equal far below the solve tolerance."""
    pop, cfg, hier = setup16s
    solver = MGSolver(hier, cfg.solver)
    probes = make_probe_source("jax", 9)
    X = probes(0, 8, pop.n, hier.levels[0].op.dtype)
    ref = solver.solve(X, 1e-10)
    mesh = make_mesh(shape, ("samples", "x"))
    ss = ShardedMGSolver(hier, mesh, cfg.solver)
    res = ss.solve(X, 1e-10)
    assert np.array_equal(np.asarray(res.iters), np.asarray(ref.iters))
    dx = max(
        np.abs(np.asarray(res.x.re) - np.asarray(ref.x.re)).max(),
        np.abs(np.asarray(res.x.im) - np.asarray(ref.x.im)).max(),
    )
    assert dx < 1e-9, dx
    assert float(np.asarray(res.resnorm / res.bnorm).max()) < 1e-10


def test_sharded_solve_gmres_smoother(setup16s):
    """The psum'd-dot GMRES smoother path (cfg.smoother='gmres' is the
    default; the poly path has no reductions and is covered above)."""
    pop, cfg, hier = setup16s
    import dataclasses

    scfg = dataclasses.replace(cfg.solver, smoother="gmres")
    solver = MGSolver(hier, scfg)
    probes = make_probe_source("jax", 13)
    X = probes(0, 4, pop.n, hier.levels[0].op.dtype)
    ref = solver.solve(X, 1e-10)
    mesh = make_mesh((2, 4), ("samples", "x"))
    ss = ShardedMGSolver(hier, mesh, scfg)
    res = ss.solve(X, 1e-10)
    assert np.array_equal(np.asarray(res.iters), np.asarray(ref.iters))
    dx = np.abs(np.asarray(res.x.re) - np.asarray(ref.x.re)).max()
    assert dx < 1e-9, dx


def test_hutchinson_mesh_invariance(setup16s, op16):
    """hutchinson() end-to-end: unsharded == sample-DP mesh (same counter-
    keyed probe stream) == lattice-sharded mesh to solver tolerance. This is
    the SURVEY section 4 estimator contract. Sample counts are capped so the
    test measures INVARIANCE, not convergence (covered by test_trace.py)."""
    op, _ = op16
    pop, cfg, hier = setup16s
    # fixed 2 batches of 8: the stopping rule never fires, every config
    # sees the exact same 16 counter-keyed probes
    cfgq = cfg.replace(max_nr_ests=16, trace_tol=1e-8, nr_deflat_vctrs=4)
    r0 = hutchinson(op, cfgq, hier=hier, verbose=False)
    r_dp = hutchinson(op, cfgq, hier=hier, verbose=False,
                      mesh=make_mesh((8,), ("samples",)))
    assert r_dp["nr_ests"] == r0["nr_ests"] == 16
    assert abs(r_dp["trace"] - r0["trace"]) < 1e-9 * abs(r0["trace"])
    assert abs(r_dp["std_dev"] - r0["std_dev"]) < 1e-7

    r_xs = hutchinson(op, cfgq, hier=hier, verbose=False,
                      mesh=make_mesh((2, 4), ("samples", "x")))
    assert r_xs["nr_ests"] == r0["nr_ests"]
    # per-probe estimates agree to solve tolerance, so the means do too
    assert abs(r_xs["trace"] - r0["trace"]) < 1e-6 * abs(r0["trace"])


def test_mlmc_lattice_sharded(setup16s, op16):
    """mlmc() with level-0 solves lattice-sharded matches the unsharded run
    sample-for-sample (capped counts; convergence covered by test_trace.py)."""
    op, _ = op16
    pop, cfg, hier = setup16s
    cfgq = cfg.replace(max_nr_ests=8, trace_tol=1e-8, nr_deflat_vctrs=4)
    r0 = mlmc(op, cfgq, hier=hier, verbose=False)
    r_xs = mlmc(op, cfgq, hier=hier, verbose=False,
                mesh=make_mesh((2, 4), ("samples", "x")))
    for a, b in zip(r0["results"], r_xs["results"]):
        assert a["nr_ests"] == b["nr_ests"]
    assert abs(r_xs["trace"] - r0["trace"]) < 1e-6 * abs(r0["trace"])


def test_sharded_deflation_basis_matches_replicated(setup16s):
    """SURVEY.md P4: the Hutchinson deflation-basis solves routed through the
    lattice-sharded solver (basis rows sharded over 'samples', lattice over
    'x') produce the same smallest eigenvalues and the same exact tr1
    correction as the replicated path, to solve tolerance."""
    from deflatedmlmc_schwinger_tpu.trace.deflation import hutchinson_deflation

    pop, cfg, hier = setup16s
    cfg = cfg.replace(
        nr_deflat_vctrs=8, defl_eigvs_tol_Hutch=1e-6, defl_subspace_rounds=12
    )
    solver = MGSolver(hier, cfg.solver)
    defl_rep = hutchinson_deflation(pop, solver, cfg)

    mesh = make_mesh((4, 2), ("samples", "x"))
    fine = ShardedMGSolver(hier, mesh, cfg.solver)
    defl_sh = hutchinson_deflation(pop, solver, cfg, fine_solver=fine)

    # the buffered subspaces differ in size (the sharded basis pads m to a
    # shard multiple), so only the well-converged smallest modes must agree
    np.testing.assert_allclose(
        np.sort(np.abs(defl_sh.values))[:4],
        np.sort(np.abs(defl_rep.values))[:4],
        rtol=1e-2,
    )
    # tr1 ('solve' mode) is exact for each basis; both bases capture the same
    # dominant low modes, so the corrections agree to basis accuracy
    assert abs(defl_sh.tr1 - defl_rep.tr1) < 5e-2 * max(abs(defl_rep.tr1), 1.0)
