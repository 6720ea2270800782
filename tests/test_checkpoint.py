"""Checkpoint/resume tests (SURVEY.md section 5.4)."""

import numpy as np
import jax.numpy as jnp

from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.trace.stats import RunningMoments
from deflatedmlmc_schwinger_tpu.utils.checkpoint import (
    EstimatorState,
    load_hierarchy,
    save_hierarchy,
)
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16


def test_hierarchy_roundtrip(tmp_path, op16):
    from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy
    from deflatedmlmc_schwinger_tpu.config import TraceConfig

    op, A = op16
    cfg = TraceConfig(
        matrix=SPEC16, mass=MASS16, latt_dims=(16, 16),
        max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low",
        test_vectors_type="RSVs", use_permuted=True, x_displacement=2,
        chebyshev_degree=10, subspace_iters=2,
    )
    hier = setup_hierarchy(op, cfg)
    path = str(tmp_path / "hier.npz")
    save_hierarchy(hier, path)
    hier2 = load_hierarchy(path, jnp.float64)
    assert hier2.sizes() == hier.sizes()
    assert [l.perm_shift for l in hier2.levels] == [l.perm_shift for l in hier.levels]
    np.testing.assert_array_equal(
        hier2.levels[1].op.complex_matrix(), hier.levels[1].op.complex_matrix()
    )
    np.testing.assert_array_equal(
        cplx.to_complex(hier2.levels[0].P.blocks),
        cplx.to_complex(hier.levels[0].P.blocks),
    )
    np.testing.assert_array_equal(
        cplx.to_complex(hier2.coarsest_inv), cplx.to_complex(hier.coarsest_inv)
    )
    # the loaded stencil operator still matches the CSR oracle
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, op.n)) + 1j * rng.standard_normal((2, op.n))
    y = cplx.to_complex(hier2.levels[0].op.matvec(cplx.from_complex(x)))
    np.testing.assert_allclose(y, (A @ x.T).T, rtol=1e-12)


def test_estimator_state_roundtrip(tmp_path):
    m = RunningMoments()
    m.update_batch(np.asarray([1 + 2j, 3 - 1j, 0.5 + 0.5j]))
    st = EstimatorState(moments={"level0": m}, next_index={"level0": 24})
    path = str(tmp_path / "state.json")
    st.save(path)
    st2 = EstimatorState.load(path)
    m2 = st2.moments["level0"]
    assert m2.count == m.count
    assert abs(m2.mean - m.mean) < 1e-15
    assert abs(m2.m2 - m.m2) < 1e-15
    assert st2.next_index["level0"] == 24


def test_resume_continues_same_stream(tmp_path, op16):
    """A run interrupted after N samples and resumed produces the same
    estimate trajectory as an uninterrupted run (counter-keyed probes)."""
    from deflatedmlmc_schwinger_tpu.config import TraceConfig
    from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu.trace import hutchinson

    op, A = op16
    cfg = TraceConfig(
        matrix=SPEC16, mass=MASS16, latt_dims=(16, 16),
        max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low",
        test_vectors_type="RSVs", use_permuted=False, trace_tol=1e-2,
        nr_deflat_vctrs=0, chebyshev_degree=10, subspace_iters=2,
        probe_batch=4, max_nr_ests=8, min_nr_ests=6,
    )
    hier = setup_hierarchy(op, cfg)
    solver = MGSolver(hier, cfg.solver)
    ck = str(tmp_path / "ck")
    # interrupted run: max 4 samples
    r1 = hutchinson(op, cfg.replace(max_nr_ests=4), solver=solver,
                    verbose=False, checkpoint_dir=ck)
    assert r1["nr_ests"] == 4
    # resumed run: continues to 8
    r2 = hutchinson(op, cfg, solver=solver, verbose=False, checkpoint_dir=ck)
    # uninterrupted control
    r3 = hutchinson(op, cfg, solver=solver, verbose=False)
    assert r2["nr_ests"] == r3["nr_ests"] == 8
    assert abs(r2["trace"] - r3["trace"]) < 1e-8


def test_mlmc_resume_continues_same_stream(tmp_path, op16):
    """MLMC per-level sampling state resumes on the same probe stream."""
    from deflatedmlmc_schwinger_tpu.config import TraceConfig
    from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu.trace import mlmc

    op, A = op16
    cfg = TraceConfig(
        matrix=SPEC16, mass=MASS16, latt_dims=(16, 16),
        max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low",
        test_vectors_type="RSVs", use_permuted=False, trace_tol=1e-2,
        nr_deflat_vctrs=0, mlmc_deflat_vctrs=(0, 0), mlmc_levels_to_skip=(),
        chebyshev_degree=10, subspace_iters=2,
        probe_batch=4, max_nr_ests=8, min_nr_ests=6,
    )
    hier = setup_hierarchy(op, cfg)
    solver = MGSolver(hier, cfg.solver)
    ck = str(tmp_path / "ck")
    r1 = mlmc(op, cfg.replace(max_nr_ests=4), solver=solver, verbose=False,
              checkpoint_dir=ck)
    assert r1["results"][0]["nr_ests"] == 4
    r2 = mlmc(op, cfg, solver=solver, verbose=False, checkpoint_dir=ck)
    r3 = mlmc(op, cfg, solver=solver, verbose=False)
    for lev in range(2):
        assert (r2["results"][lev]["nr_ests"] == r3["results"][lev]["nr_ests"])
    assert abs(r2["trace"] - r3["trace"]) < 1e-8
