"""Multigrid hierarchy + solver tests (survey section 4 oracles: P/R
adjointness, Galerkin identity ||A_c - R A P||, ||RP - I||, V-cycle
contraction, retargeted solves)."""

import numpy as np
import jax.numpy as jnp
import pytest

from deflatedmlmc_schwinger_tpu.config import SolverConfig, TraceConfig
from deflatedmlmc_schwinger_tpu.mg import MGSolver, check_quality, setup_hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16


def make_cfg(**kw):
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
        chebyshev_degree=50,
        subspace_iters=4,
    )
    base.update(kw)
    return TraceConfig(**base)


@pytest.fixture(scope="module")
def hier16(op16):
    op, _ = op16
    return setup_hierarchy(op, make_cfg())


def test_hierarchy_sizes(hier16):
    assert hier16.sizes() == (512, 256, 64)


def test_quality_invariants(hier16):
    q = check_quality(hier16)
    assert q["orthonormality of P at level 0"] < 1e-12
    assert q["orthonormality of P at level 1"] < 1e-12
    assert q["g3-compatibility at level 0"] == 0.0
    assert q["hermiticity of g3*A at level 1"] < 1e-12
    assert q["hermiticity of g3*A at level 2"] < 1e-12


def test_setup_fine_eigs_device(op16):
    """setup_fine_eigs='device' (the large-lattice fast path: fine-level
    test vectors from the device-resident CheFSI) must produce a hierarchy
    with the same structural invariants as the host path."""
    op, _ = op16
    hier = setup_hierarchy(op, make_cfg(setup_fine_eigs="device"))
    assert hier.sizes() == (512, 256, 64)
    q = check_quality(hier)
    assert q["orthonormality of P at level 0"] < 1e-6
    assert q["hermiticity of g3*A at level 1"] < 1e-10
    # and it solves: V-cycle-preconditioned FGMRES converges on random rhs
    s = MGSolver(hier)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((2, 512)) + 1j * rng.standard_normal((2, 512))
    r = s.solve(b, 1e-8)
    assert float(np.max(np.asarray(r.resnorm / r.bnorm))) < 1e-7


@pytest.mark.parametrize("backend", ["host", "device"])
def test_check_quality_flag_honored(op16, backend, capsys):
    """check_quality_MG=True must print the invariant checks on BOTH setup
    backends (reference: multigrid.py:282-316; the flag was a silent no-op on
    the default 'host' path before round 5)."""
    op, _ = op16
    setup_hierarchy(op, make_cfg(check_quality_MG=True, setup_backend=backend))
    out = capsys.readouterr().out
    assert "orthonormality of P at level 0" in out
    assert "hermiticity of g3*A at level 1" in out


def test_galerkin_identity(hier16, op16, dense16):
    P0 = hier16.levels[0].P.to_dense()
    C1 = P0.conj().T @ dense16 @ P0
    assert np.abs(C1 - hier16.levels[1].op.complex_matrix()).max() < 1e-12
    P1 = hier16.levels[1].P.to_dense()
    C2 = P1.conj().T @ C1 @ P1
    assert np.abs(C2 - hier16.levels[2].op.complex_matrix()).max() < 1e-12


def test_P_R_adjointness(hier16):
    rng = np.random.default_rng(0)
    P = hier16.levels[0].P
    x = cplx.from_complex(rng.standard_normal((2, P.n_fine)) + 1j * rng.standard_normal((2, P.n_fine)))
    y = cplx.from_complex(rng.standard_normal((2, P.n_coarse)) + 1j * rng.standard_normal((2, P.n_coarse)))
    # <x, P y> == <R x, y>
    lhs = np.vdot(cplx.to_complex(x), cplx.to_complex(P.apply(y)))
    rhs = np.vdot(cplx.to_complex(P.apply_adjoint(x)), cplx.to_complex(y))
    assert abs(lhs - rhs) < 1e-10


def test_coarsest_inverse(hier16):
    Ac = hier16.levels[-1].op.complex_matrix()
    inv = cplx.to_complex(hier16.coarsest_inv)
    assert np.abs(Ac @ inv - np.eye(Ac.shape[0])).max() < 1e-10


def test_mg_preconditioned_solve(hier16, op16):
    op, A = op16
    rng = np.random.default_rng(1)
    b = rng.standard_normal((3, op.n)) + 1j * rng.standard_normal((3, op.n))
    solver = MGSolver(hier16, SolverConfig(restart=25, max_restarts=10, smooth_iters=4))
    res = solver.solve(b, tol=1e-10)
    x = cplx.to_complex(res.x)
    relres = np.linalg.norm(b.T - A @ x.T, axis=0) / np.linalg.norm(b, axis=1)
    assert (relres < 1e-9).all()
    # the preconditioner must beat plain FGMRES by a wide margin
    assert int(np.max(np.asarray(res.iters))) < 60


def test_solve_from_coarse_level(hier16):
    rng = np.random.default_rng(2)
    n1 = hier16.levels[1].n
    b = rng.standard_normal((2, n1)) + 1j * rng.standard_normal((2, n1))
    solver = MGSolver(hier16)
    res = solver.solve(b, tol=1e-10, level=1)
    x = cplx.to_complex(res.x)
    A1 = hier16.levels[1].op.complex_matrix()
    relres = np.linalg.norm(b - x @ A1.T, axis=1) / np.linalg.norm(b, axis=1)
    assert (relres < 1e-9).all()


def test_vcycle_contracts(hier16, op16):
    """One V-cycle must reduce the residual of a random system."""
    op, A = op16
    rng = np.random.default_rng(3)
    b = rng.standard_normal((2, op.n)) + 1j * rng.standard_normal((2, op.n))
    solver = MGSolver(hier16)
    vc = solver.precond(0)
    x = cplx.to_complex(vc(cplx.from_complex(b)))
    r = np.asarray(b) - (np.asarray(A @ x.T)).T if False else b - x @ np.asarray(A.todense()).T
    ratio = np.linalg.norm(r, axis=1) / np.linalg.norm(b, axis=1)
    assert (ratio < 0.7).all(), ratio


def test_block_stencil_coarse_matches_dense(op16):
    """'auto' coarse format packs level 1 as a cyclic block stencil whose
    matvec and reconstruction equal the dense Galerkin operator."""
    from deflatedmlmc_schwinger_tpu.mg.hierarchy import BlockStencilOperator
    from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy

    op, A = op16
    cfg = make_cfg(coarse_format="auto")
    hb = setup_hierarchy(op, cfg)
    cfgd = make_cfg(coarse_format="dense")
    hd = setup_hierarchy(op, cfgd)
    op1 = hb.levels[1].op
    assert isinstance(op1, BlockStencilOperator)
    assert len(op1.offsets) < 48
    Cb = op1.complex_matrix()
    Cd = hd.levels[1].op.complex_matrix()
    np.testing.assert_allclose(Cb, Cd, atol=1e-12)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, op1.n)) + 1j * rng.standard_normal((3, op1.n))
    y = cplx.to_complex(op1.matvec(cplx.from_complex(x)))
    np.testing.assert_allclose(y, x @ Cd.T, atol=1e-10)


def test_galerkin_block_stencil_matches_dense(op16):
    """Device-side block-sparse Galerkin == dense host Galerkin."""
    import jax.numpy as jnp
    from deflatedmlmc_schwinger_tpu.config import TraceConfig
    from deflatedmlmc_schwinger_tpu.mg.setup import (
        _test_vectors,
        build_P_blocks,
        galerkin_block_stencil,
        galerkin_coarse,
    )
    from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator

    op, _ = op16
    pop = pair_operator(op)
    cfg = TraceConfig(
        matrix=SPEC16, mass=MASS16, latt_dims=(16, 16),
        max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low",
        test_vectors_type="RSVs", use_permuted=False,
        chebyshev_degree=10, subspace_iters=2,
    )
    tv = _test_vectors(pop, 2, cfg, 1, 1e-3)
    P = build_P_blocks(tv, cfg.aggrs[0] * 2, 2, pop.dtype)
    C = galerkin_coarse(pop, P, pop.dtype)
    bs = galerkin_block_stencil(pop, P, pop.dtype)
    assert bs is not None
    np.testing.assert_allclose(bs.complex_matrix(), C, rtol=1e-12, atol=1e-12)


def test_poly_smoother_vcycle_converges(op16):
    """'poly' smoothing (fixed GMRES-polynomial, no reductions) gives a
    working V-cycle: preconditioned FGMRES converges in a comparable
    iteration count to the adaptive 'gmres' smoother."""
    from deflatedmlmc_schwinger_tpu.config import SolverConfig, TraceConfig
    from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu.ops import cplx

    op, A = op16
    cfg = TraceConfig(
        matrix=SPEC16, mass=MASS16, latt_dims=(16, 16),
        max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low",
        test_vectors_type="RSVs", use_permuted=False,
        chebyshev_degree=10, subspace_iters=2,
    )
    hier = setup_hierarchy(op, cfg)
    rng = np.random.default_rng(1)
    b = cplx.from_complex(
        rng.standard_normal((4, op.n)) + 1j * rng.standard_normal((4, op.n))
    )
    res_g = MGSolver(hier, SolverConfig(smoother="gmres")).solve(b, 1e-9)
    res_p = MGSolver(hier, SolverConfig(smoother="poly")).solve(b, 1e-9)
    assert float(np.max(np.asarray(res_p.resnorm / res_p.bnorm))) < 1e-9
    it_g = int(np.max(np.asarray(res_g.iters)))
    it_p = int(np.max(np.asarray(res_p.iters)))
    assert it_p <= 2 * it_g, (it_p, it_g)


@pytest.mark.parametrize("smoother", ["poly", "gmres"])
def test_vcycle_with_residual_emits_true_residual(hier16, smoother):
    """build_v_cycle(with_residual=True) returns (z, b - A z)."""
    from deflatedmlmc_schwinger_tpu.mg.cycle import MGSolver as _MGS
    from deflatedmlmc_schwinger_tpu.mg.cycle import build_v_cycle

    solver = _MGS(hier16, SolverConfig(smoother=smoother, smooth_iters=3))
    vc = build_v_cycle(
        hier16.levels, hier16.coarsest_inv, solver._smoothers(0),
        with_residual=True,
    )
    rng = np.random.default_rng(31)
    n = hier16.levels[0].n
    b = cplx.from_complex(
        rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    )
    z, r = vc(b)
    r_true = b - hier16.levels[0].op.matvec(z)
    np.testing.assert_allclose(
        cplx.to_complex(r), cplx.to_complex(r_true), atol=1e-11
    )
    # and it agrees with the plain V-cycle
    z2 = solver.precond(0)(b)
    np.testing.assert_allclose(
        cplx.to_complex(z), cplx.to_complex(z2), atol=1e-12
    )


def test_fused_matvec_precond_solve_matches_plain(hier16):
    """MGSolver.solve routes through matvec_precond; it must produce the
    same solutions/iterations as the explicit precond+matvec pair."""
    from deflatedmlmc_schwinger_tpu.solvers.fgmres import fgmres

    solver = MGSolver(hier16, SolverConfig(smoother="poly", smooth_iters=4))
    rng = np.random.default_rng(37)
    n = hier16.levels[0].n
    b = cplx.from_complex(
        rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    )
    kw = dict(tol=1e-10, restart=20, max_restarts=10)
    r1 = fgmres(solver.matvec(0), b, precond=solver.precond(0), **kw)
    r2 = fgmres(solver.matvec(0), b,
                matvec_precond=solver.precond_matvec(0), **kw)
    assert np.array_equal(np.asarray(r1.iters), np.asarray(r2.iters))
    np.testing.assert_allclose(
        cplx.to_complex(r2.x), cplx.to_complex(r1.x), atol=1e-9
    )
    assert float(np.max(np.asarray(r2.resnorm / r2.bnorm))) < 1e-10


def test_grouped_band_packing_exact(hier16, dense16):
    """pack_grouped's grouped-band matvec is exact: packed == unpacked ==
    dense oracle on the level-1 Galerkin operator."""
    import dataclasses

    from deflatedmlmc_schwinger_tpu.mg.hierarchy import (
        BlockStencilOperator,
        pack_grouped,
    )

    op1 = hier16.levels[1].op
    if not isinstance(op1, BlockStencilOperator):
        pytest.skip("level 1 not packed as a block stencil")
    unpacked = BlockStencilOperator(blocks=op1.blocks, offsets=op1.offsets)
    packed = pack_grouped(unpacked, group=8)
    rng = np.random.default_rng(41)
    n = op1.n
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    v = cplx.from_complex(z)
    y_un = cplx.to_complex(unpacked.matvec(v))
    y_pk = cplx.to_complex(packed.matvec(v))
    np.testing.assert_allclose(y_pk, y_un, atol=1e-12)
    C = unpacked.complex_matrix()
    np.testing.assert_allclose(y_pk, z @ C.T, atol=1e-11)


def test_derived_solver_cached(hier16):
    """derived() hands back ONE cached instance per SolverConfig: the fgmres
    jit key includes the solver's (static) closure callables, so a fresh
    MGSolver per setup phase would retrace and re-load the whole program
    family on every deflation call (mg/cycle.py derived)."""
    solver = MGSolver(hier16, SolverConfig(smoother="poly", smooth_iters=4))
    shallow = SolverConfig(smoother="poly", smooth_iters=2)
    d1 = solver.derived(shallow)
    d2 = solver.derived(SolverConfig(smoother="poly", smooth_iters=2))
    assert d1 is d2
    assert d1 is not solver and d1.cfg == shallow
    # same config as the parent -> the parent itself (no duplicate programs)
    assert solver.derived(SolverConfig(smoother="poly", smooth_iters=4)) is solver
    assert solver.derived(None) is solver
    # the derived solver solves correctly over the same hierarchy
    rng = np.random.default_rng(11)
    n = hier16.levels[0].n
    b = cplx.from_complex(
        rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    )
    res = d1.solve(b, 1e-8)
    assert float(np.max(np.asarray(res.resnorm / res.bnorm))) < 1e-8


def test_poly_smoother_residual_recurrence(op16):
    """poly_smoother(with_residual=True) returns exactly (x, r - A x)."""
    import jax

    from deflatedmlmc_schwinger_tpu.mg.cycle import poly_smoother
    from deflatedmlmc_schwinger_tpu.ops import cplx
    from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator

    op, _ = op16
    pop = pair_operator(op)
    rng = np.random.default_rng(29)
    roots = tuple(
        complex(a, b)
        for a, b in zip(rng.standard_normal(3) + 3.0, rng.standard_normal(3))
    )
    z = rng.standard_normal((2, pop.n)) + 1j * rng.standard_normal((2, pop.n))
    r = cplx.from_complex(z)
    mv = jax.jit(pop.matvec)
    x, cur = poly_smoother(mv, r, roots, with_residual=True)
    x2 = poly_smoother(mv, r, roots)
    np.testing.assert_allclose(
        cplx.to_complex(x), cplx.to_complex(x2), atol=1e-13
    )
    np.testing.assert_allclose(
        cplx.to_complex(cur), cplx.to_complex(r - pop.matvec(x)), atol=1e-12
    )
