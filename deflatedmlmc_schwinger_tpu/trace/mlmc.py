"""Deflated multigrid multilevel Monte Carlo trace estimator
(reference: stoch_trace.py:185-471).

Telescoping sum over the MG hierarchy:
  tr(A_0^{-1}) = sum_l tr(A_l^{-1} - P_l A_{l+1}^{-1} R_l) + tr(A_coarsest^{-1}),
each difference level estimated stochastically with its own share of the
tolerance budget and optional deflation; the coarsest level is computed
exactly from the precomputed dense inverse. Optional level skipping collapses
levels 1 and 2 into one composite difference (only "skip level 1", as in the
reference, stoch_trace.py:199-206).

Displaced-trace variant: probes are pushed through Pi_l^T and the accumulated
B-block operator (reference: utils.py:288-290, multigrid.py:318-331); the
coarsest term becomes tr(Pi_c^T A_c^{-1} B_c) (stoch_trace.py:431-435).
"""

from __future__ import annotations

from math import sqrt
from typing import Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu.mg.diff_op import level_structure
from deflatedmlmc_schwinger_tpu.mg.hierarchy import Hierarchy
from deflatedmlmc_schwinger_tpu.mg.setup import setup_hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.stencil_kernel import plain_under_mesh
from deflatedmlmc_schwinger_tpu.ops.dirac import (
    StencilOperator,
    pair_operator,
    shift_rows_down_pair,
    shift_rows_up_pair,
)
from deflatedmlmc_schwinger_tpu.trace.deflation import (
    Deflation,
    deflate,
    hutchinson_deflation,
    mlmc_level_deflation,
)
from deflatedmlmc_schwinger_tpu.trace.hutchinson import hutchinson_step_batch
from deflatedmlmc_schwinger_tpu.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu.trace.stats import (
    ConfirmedStop,
    RunningMoments,
    check_stalled,
    should_stop,
)
from deflatedmlmc_schwinger_tpu.utils.flops import flops_vcycle, level_nnz
from deflatedmlmc_schwinger_tpu.utils.timer import PhaseTimer


def bblock_apply(hier: Hierarchy, level: int, v: CP) -> CP:
    """Apply the accumulated B-block operator B_l (lazy composition; the
    reference materializes sparse matrices, multigrid.py:328-331):
    B_0 = I;  B_l = R_{l-1} B_{l-1} Pi_{l-1}^H P_{l-1} Pi_l."""
    if level == 0:
        return v
    w = shift_rows_up_pair(v, hier.levels[level].perm_shift)
    w = hier.levels[level - 1].P.apply(w)
    w = shift_rows_down_pair(w, hier.levels[level - 1].perm_shift)
    w = bblock_apply(hier, level - 1, w)
    return hier.levels[level - 1].P.apply_adjoint(w)


def bblock_matrix(hier: Hierarchy, level: int) -> np.ndarray:
    """Materialize B_l as a host complex (n_l, n_l) matrix (coarsest only)."""
    n = hier.levels[level].n
    rdtype = hier.levels[level].op.dtype
    eye = CP(jnp.eye(n, dtype=rdtype), jnp.zeros((n, n), rdtype))
    rows = bblock_apply(hier, level, eye)  # row j = B e_j
    return cplx.to_complex(rows).T


def bblock_matrix_host(hier: Hierarchy, level: int) -> np.ndarray:
    """Host sparse construction of B_l = R_{l-1} B_{l-1} Pi_{l-1}^H P_{l-1}
    Pi_l (the reference materializes the same sparse products,
    multigrid.py:328-331): P is aggregate-block-diagonal and Pi a cyclic
    permutation, so the whole recursion is sparse matmuls in milliseconds --
    no device programs, no transfers beyond the small P blocks. Used by
    the exact-level and coarsest-trace phases; the sampling path keeps the
    lazy device composition (bblock_apply)."""
    import scipy.sparse as sp

    def P_sparse(P) -> "sp.csr_matrix":
        b = np.asarray(cplx.to_complex(P.blocks)).astype(np.complex128)
        return sp.block_diag(list(b), format="csr")

    def Pi(n: int, d: int):
        rows = np.arange(n)
        return sp.csr_matrix(
            (np.ones(n), (rows, (rows + d) % n)), shape=(n, n)
        )

    B = sp.identity(hier.levels[0].n, format="csr", dtype=np.complex128)
    for l in range(1, level + 1):
        Pl = P_sparse(hier.levels[l - 1].P)
        Pi_prev = Pi(hier.levels[l - 1].n, hier.levels[l - 1].perm_shift)
        Pi_l = Pi(hier.levels[l].n, hier.levels[l].perm_shift)
        B = Pl.conj().T @ (B @ (Pi_prev.conj().T @ (Pl @ Pi_l)))
    return np.asarray(B.todense())


def dense_level_inverse(hier: Hierarchy, level: int) -> np.ndarray:
    """Host f64 dense inverse of the level operator (complex128 (n, n)).

    The inversion ALWAYS runs in complex128: the Galerkin coarse operators
    are exactly the ill-conditioned matrices the dense-exact feature exists
    to sidestep (their f32 iterative floor is ~1e-2), and an f32
    np.linalg.inv would carry ~eps32*kappa forward error into levels that
    report ests_dev=0 and sit outside the stopping contract -- a silent
    bias. The stored f32 ENTRIES are an O(eps32*||A||) backward
    perturbation of the exact operator (benign); the f64 inversion removes
    the kappa-amplified solve error. A stencil fine level is materialized
    on the HOST in complex128 (ops/dirac.py stencil_matvec_host) instead of
    through the device-dtype matvec."""
    op = hier.levels[level].op
    if hasattr(op, "complex_matrix"):
        M = np.asarray(op.complex_matrix()).astype(np.complex128)
    elif hasattr(op, "coeffs") and hasattr(op, "nx"):
        from deflatedmlmc_schwinger_tpu.ops.dirac import stencil_matvec_host

        n = hier.levels[level].n
        C = (np.asarray(op.coeffs.re, np.float64)
             + 1j * np.asarray(op.coeffs.im, np.float64))
        # rows of the identity through the host stencil: row j = A e_j
        M = stencil_matvec_host(C, np.eye(n, dtype=np.complex128), op.nx, op.nt).T
    else:
        n = hier.levels[level].n
        eye = CP(jnp.eye(n, dtype=op.dtype), jnp.zeros((n, n), op.dtype))
        M = np.asarray(cplx.to_complex(op.matvec(eye))).astype(np.complex128).T
    return np.linalg.inv(M)


def exact_difference_trace(
    hier: Hierarchy,
    level: int,
    skip_level: bool,
    use_permuted: bool,
    *,
    Ac_inv: Optional[np.ndarray] = None,
    Af_inv: Optional[np.ndarray] = None,
) -> complex:
    """Exactly evaluate one telescoping difference term on the host in f64,
    tr((A_l^{-1} - P_l A_c^{-1} R_l) B_l Pi_l^T) -- the dense generalization
    of the reference's exact-coarsest rule (config.py mlmc_exact_dense_max_n;
    reference computes only the coarsest this way, stoch_trace.py:418-437).

    ``Ac_inv``/``Af_inv``: optionally pass precomputed dense inverses (the
    sampling path's coarse-apply inverse is reused here)."""
    fine = level
    coarse = level + 2 if (skip_level and level == 0) else level + 1
    if Af_inv is None:
        Af_inv = dense_level_inverse(hier, fine)
    P = hier.levels[fine].P.to_dense()
    if skip_level and level == 0:
        P = P @ hier.levels[1].P.to_dense()
    if Ac_inv is None:
        Ac_inv = dense_level_inverse(hier, coarse)
    M = Af_inv - P @ Ac_inv @ P.conj().T
    if not use_permuted:
        return complex(np.trace(M))
    # displaced trace tr(M B_l Pi_l^T) WITHOUT the n^3 product M @ B_l:
    # tr(M N) = sum(M * N^T) elementwise, and N = B_l Pi_l^T is a column
    # roll of the host-sparse B_l (tests/test_permuted.py pins the roll
    # identity; bblock_matrix_host == the device bblock operator)
    Bl = bblock_matrix_host(hier, level)
    N = np.roll(Bl, -hier.levels[level].perm_shift, axis=1)
    return complex(np.sum(M * N.T))


def mlmc_step_batch(
    solver: MGSolver,
    cfg: TraceConfig,
    level: int,
    defl: Deflation,
    probes: jnp.ndarray,
    skip_level: bool,
    fine_solver=None,
    gather: bool = True,
    coarse_dense_inv: Optional[CP] = None,
):
    """One batch of difference-level estimates (reference: utils.py:252-357).
    Returns (estimates (B,), fine iters (B,), coarse iters (B,),
    coarse_level, stalled (B,) -- rows whose fine or coarse solve ended
    above tolerance).

    ``fine_solver``: optional lattice-sharded solver for the LEVEL-0 systems
    (parallel/sharded_solve.py); coarse levels always run replicated.

    ``coarse_dense_inv``: optional precomputed dense inverse (CP pair,
    (n_c, n_c)) of the coarse operator -- one matmul replaces the
    iterative coarse solve (config.py mlmc_exact_dense_max_n: the f32
    iterative coarse solve floors at ~1e-2 relative residual, the dense
    apply does not)."""
    hier = solver.hier
    fine, coarse, restrict, prolong = level_structure(solver, level, skip_level)
    coarsest = hier.nr_levels - 1
    x0 = probes

    if defl.U is not None and cfg.defl_type == "inexact_03":
        # oblique projector x - V (U^H A V)^{-1} U^H A x (utils.py:269-276);
        # the small inverse defl.proj_B is precomputed once per level
        # (trace/deflation.py) -- only A x0 is applied per batch (device)
        Af = solver.matvec(level)
        t = cplx.matmul_right_conjT(Af(x0), defl.aux_V)          # (B, k)
        coef = cplx.matmul_right(t, defl.proj_B)                 # (B, k) @ Bl^T
        x_def = x0 - cplx.matmul_right(coef, defl.U)
    else:
        x_def = deflate(x0, defl.U)

    d = hier.levels[level].perm_shift
    if cfg.use_permuted:
        x_def = shift_rows_down_pair(x_def, d)
        x_def = bblock_apply(hier, level, x_def)

    if fine_solver is not None and fine == 0:
        res_f = fine_solver.solve(x_def, cfg.function_tol)
    else:
        res_f = solver.solve(x_def, cfg.function_tol, level=fine)
    e1 = cplx.cdot(x0, res_f.x)

    xc = restrict(x_def)
    if coarse == coarsest:
        y = solver.coarsest_solve(xc)
        iters2 = jnp.ones(x0.re.shape[0], jnp.int32)
        stalled = res_f.stalled   # the dense coarsest apply cannot stall
    elif coarse_dense_inv is not None:
        y = cplx.matmul_right(xc, coarse_dense_inv)
        iters2 = jnp.ones(x0.re.shape[0], jnp.int32)
        stalled = res_f.stalled   # dense apply: no iteration, no stall
    else:
        res_c = solver.solve(xc, cfg.function_tol, level=coarse)
        y = res_c.x
        iters2 = res_c.iters
        stalled = jnp.logical_or(res_f.stalled, res_c.stalled)
    w = prolong(y)
    e2 = cplx.cdot(x0, w)
    e = e1 - e2
    if not gather:
        # device values for the device-resident stopping path (trace/stats.py)
        return e, res_f.iters, iters2, coarse, stalled
    # full batch on every process (see trace/hutchinson.py)
    from deflatedmlmc_schwinger_tpu.parallel.distributed import global_values

    es = global_values(e.re) + 1j * global_values(e.im)
    return (es, global_values(res_f.iters), global_values(iters2), coarse,
            global_values(stalled))


def _adaptive_sampling(
    solver, cfg, hier, defls, rough_trace, results, state, state_ckpt,
    probe_source, skip_level, fine_solver, mesh, log,
    exact_set=frozenset(), dense_invs=None,
):
    """Optimal-allocation MLMC sampling (SURVEY.md P2): interleaved batches,
    each issued to the level with the largest marginal variance reduction
    per unit cost, until the AGGREGATE standard error of the telescoping sum
    sqrt(sum_l V_l / n_l) meets the total budget |trace_tol * rough_trace|.

    This is the classic optimal-MLMC allocation n_l ~ sqrt(V_l / C_l)
    realized greedily from measured variances and batch wall-clock costs
    (compile-skewed first measurements are replaced once a second batch
    lands), instead of the reference's fixed per-level tolerance split
    (stoch_trace.py:327-336). Same total-variance contract, strictly less
    work when level variances/costs are unbalanced."""
    import time as _time

    from deflatedmlmc_schwinger_tpu.utils.checkpoint import EstimatorState

    nr_levels = hier.nr_levels
    B = int(cfg.probe_batch)
    dense_invs = dense_invs or {}
    eps_tot = cfg.stop_safety * abs(cfg.trace_tol * rough_trace)
    # dense-exact levels contribute zero variance and take no samples, so
    # the whole aggregate budget goes to the remaining stochastic levels
    active = [
        i for i in range(nr_levels - 1)
        if not (skip_level and i == 1) and i not in exact_set
    ]
    probes = {
        i: make_probe_source(probe_source, cfg.seed + i) for i in active
    }
    moments = {
        i: state.moments.get(f"level{i}", RunningMoments()) for i in active
    }
    starts = {i: state.next_index.get(f"level{i}", 0) for i in active}
    costs: Dict[int, list] = {i: [] for i in active}
    if mesh is not None:
        from deflatedmlmc_schwinger_tpu.parallel import shard_batch

    def run_batch(i: int):
        t0 = _time.time()
        n_i = hier.levels[i].n
        X = probes[i](starts[i], B, n_i, hier.levels[i].op.dtype)
        if mesh is not None:
            X = shard_batch(X, mesh, cfg.sample_axis)
        cdi = dense_invs.get(i + 2 if (skip_level and i == 0) else i + 1)
        es, it1, it2, coarse, stall = mlmc_step_batch(
            solver, cfg, i, defls[i], X, skip_level, fine_solver,
            coarse_dense_inv=cdi,
        )
        moments[i].update_batch(es)
        results[i]["function_iters"] += int(np.sum(it1))
        results[coarse]["function_iters"] += int(np.sum(it2))
        results[i]["stalled_rows"] += int(np.sum(stall))
        starts[i] += B
        check_stalled(results[i]["stalled_rows"], moments[i].count,
                      cfg.max_stalled_frac, f"mlmc level {i}")
        dt = _time.time() - t0
        c = costs[i]
        if len(c) == 1:
            c[0] = dt     # drop the compile-skewed first measurement
        c.append(dt)
        if state_ckpt:
            state.moments[f"level{i}"] = moments[i]
            state.next_index[f"level{i}"] = starts[i]
            state.iters = {
                f"level{j}": results[j]["function_iters"]
                for j in range(nr_levels)
            }
            state.save(state_ckpt)

    def agg_var() -> float:
        return sum(
            moments[i].std_dev ** 2 / moments[i].count
            for i in active
            if moments[i].count
        )

    # warm-up: one batch per level establishes (V_l, C_l)
    for i in active:
        if moments[i].count == 0:
            run_batch(i)
    stopper = ConfirmedStop(cfg.stop_confirm)
    while any(starts[i] < cfg.max_nr_ests for i in active):
        done = all(moments[i].count >= cfg.min_nr_ests for i in active)
        total_n = sum(moments[i].count for i in active)
        if stopper(done and agg_var() < eps_tot * eps_tot, total_n):
            break
        # greedy: marginal aggregate-variance drop of one more batch at
        # level i is V_i/n_i - V_i/(n_i + B); normalize by the batch cost
        def benefit(i: int) -> float:
            m = moments[i]
            v = m.std_dev ** 2
            gain = v / m.count - v / (m.count + B)
            cost = float(np.median(costs[i])) if costs[i] else 1.0
            return gain / max(cost, 1e-9)

        cand = [i for i in active if starts[i] < cfg.max_nr_ests]
        run_batch(max(cand, key=benefit))
    for i in active:
        results[i]["nr_ests"] += moments[i].count
        results[i]["ests_avg"] = moments[i].mean + defls[i].tr1
        results[i]["ests_dev"] = moments[i].std_dev
        log(
            f"level {i}: {moments[i].count} ests (adaptive), trace "
            f"{results[i]['ests_avg']:.6f}, dev {moments[i].std_dev:.4f}"
        )


def _tolerance_fractions(nr_levels: int, skip_level: bool):
    """Per-level variance-budget split (reference: stoch_trace.py:327-336)."""
    if nr_levels < 3:
        raise Exception("Number of levels restricted to >2 for now ...")
    if nr_levels == 3:
        f0, f1 = 0.8, 0.2
    else:
        f0, f1 = 0.45, 0.45
    if skip_level:
        f0 = f0 + f1
    return f0, f1


def _level_tol_factor(i: int, nr_levels: int, f0: float, f1: float, skip_level: bool):
    """tol_fctr per level (reference: stoch_trace.py:356-362)."""
    if i == 0:
        return sqrt(f0)
    if i == 1:
        return sqrt(f1)
    if skip_level:
        return sqrt(1.0 - f0) / sqrt(nr_levels - 3)
    return sqrt(1.0 - f0 - f1) / sqrt(nr_levels - 3)


@plain_under_mesh
def mlmc(
    op: StencilOperator,
    cfg: TraceConfig,
    *,
    hier: Optional[Hierarchy] = None,
    solver: Optional[MGSolver] = None,
    probe_source: str = "jax",
    timer: Optional[PhaseTimer] = None,
    verbose: bool = True,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
) -> Dict:
    """Compute tr(A^{-1}) (or tr(A^{-1} Pi)) by deflated MG-MLMC.

    ``checkpoint_dir``: if set, the hierarchy is cached there and the
    per-difference-level sampling state (moments + next sample index)
    persists after every batch; an interrupted run resumes each level on the
    exact same counter-keyed probe stream (utils/checkpoint.py)."""
    import os

    timer = timer or PhaseTimer()
    log = print if verbose else (lambda *a, **k: None)
    # host-side operator for setup (see trace/hutchinson.py): avoids a
    # device->host coefficient download when setup_backend='host'
    op_for_setup = op
    if isinstance(op, StencilOperator):
        op = pair_operator(op)

    hier_ckpt = None
    state_ckpt = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        hier_ckpt = os.path.join(checkpoint_dir, "hierarchy.npz")
        state_ckpt = os.path.join(checkpoint_dir, "mlmc_state.json")

    # ---- skip-level validation (stoch_trace.py:199-206) ----
    skips = list(cfg.mlmc_levels_to_skip)
    if len(skips) > 1:
        raise Exception("level skipping supports at most one skipped level")
    skip_level = len(skips) == 1
    if skip_level and skips[0] != 1:
        raise Exception("only level 1 can be skipped (composite P0*P1 form)")
    if (
        cfg.mlmc_fine_deflation
        and len(cfg.mlmc_deflat_vctrs)
        and int(cfg.mlmc_deflat_vctrs[0]) > 0
    ):
        raise ValueError(
            "mlmc_fine_deflation replaces the level-0 difference-operator "
            "deflation; set mlmc_deflat_vctrs[0] = 0"
        )

    # ---- MG setup ----
    if solver is None:
        with timer.phase("mg_setup"):
            if hier is None:
                if hier_ckpt and os.path.exists(hier_ckpt):
                    from deflatedmlmc_schwinger_tpu.utils.checkpoint import load_hierarchy

                    hier = load_hierarchy(hier_ckpt, op.dtype)
                    log(f"resumed hierarchy from {hier_ckpt}")
                else:
                    hier = setup_hierarchy(op_for_setup, cfg)
                    if hier_ckpt:
                        from deflatedmlmc_schwinger_tpu.utils.checkpoint import save_hierarchy

                        save_hierarchy(hier, hier_ckpt)
            solver = MGSolver(hier, cfg.solver)
    else:
        hier = solver.hier
    nr_levels = hier.nr_levels
    if nr_levels < 3:
        raise Exception("MLMC needs a hierarchy of at least three levels")
    log(f"MG hierarchy sizes: {hier.sizes()}")

    # multi-host: global replicated hierarchy (see trace/hutchinson.py)
    if mesh is not None:
        from deflatedmlmc_schwinger_tpu.parallel import replicate
        from deflatedmlmc_schwinger_tpu.parallel.mesh import spans_processes

        if spans_processes(mesh):
            hier = replicate(hier, mesh)
            solver = MGSolver(hier, solver.cfg)

    # lattice domain decomposition for the level-0 solves (SURVEY.md P3)
    fine_solver = None
    if (
        mesh is not None
        and cfg.lattice_axis in mesh.axis_names
        and mesh.shape[cfg.lattice_axis] > 1
    ):
        from deflatedmlmc_schwinger_tpu.parallel.sharded_solve import ShardedMGSolver

        fine_solver = ShardedMGSolver(
            hier, mesh, cfg.solver,
            x_axis=cfg.lattice_axis, sample_axis=cfg.sample_axis,
        )
        log(f"level-0 solves lattice-sharded over "
            f"{mesh.shape[cfg.lattice_axis]} '{cfg.lattice_axis}' shards")

    # ---- dense-exact levels & dense coarse inverses (an extension:
    # config.py mlmc_exact_dense_max_n; reference computes only the coarsest
    # level exactly, stoch_trace.py:418-437) ----
    coarsest = nr_levels - 1
    cutoff = int(cfg.mlmc_exact_dense_max_n)

    def _coarse_of(l: int) -> int:
        return l + 2 if (skip_level and l == 0) else l + 1

    exact_set = set()
    if cutoff:
        for l in range(nr_levels - 1):
            if skip_level and l == 1:
                continue
            if hier.levels[l].n <= cutoff:
                exact_set.add(l)
    dense_inv_host: Dict[int, np.ndarray] = {}
    dense_invs: Dict[int, CP] = {}
    if cutoff:
        with timer.phase("dense_setup"):
            for l in range(nr_levels - 1):
                if (skip_level and l == 1) or l in exact_set:
                    continue
                c = _coarse_of(l)
                if c != coarsest and hier.levels[c].n <= cutoff:
                    if c not in dense_inv_host:
                        dense_inv_host[c] = dense_level_inverse(hier, c)
                    rdt = hier.levels[c].op.dtype
                    Minv = dense_inv_host[c]
                    dense_invs[c] = CP(
                        jnp.asarray(Minv.real.astype(np.dtype(rdt))),
                        jnp.asarray(Minv.imag.astype(np.dtype(rdt))),
                    )
        if exact_set:
            log(f"dense-exact difference levels: {sorted(exact_set)}")

    # ---- per-level deflation (stoch_trace.py:246-274) ----
    defls: List[Deflation] = []
    hutch_defl = None
    with timer.phase("defl_setup"):
        if cfg.mlmc_fine_deflation and 0 not in exact_set:
            # the level-0 difference probes reuse the Hutchinson gamma3
            # basis (config.py mlmc_fine_deflation); built once here, also
            # reused by the rough-trace phase below
            hutch_defl = hutchinson_deflation(op, solver, cfg,
                                              fine_solver=fine_solver)
            if mesh is not None and hutch_defl.U is not None:
                from deflatedmlmc_schwinger_tpu.trace.deflation import (
                    replicate_deflation,
                )

                hutch_defl = replicate_deflation(hutch_defl, mesh)
        for i in range(nr_levels - 1):
            if (skip_level and i == 1) or i in exact_set:
                defls.append(Deflation(U=None, tr1=0.0 + 0.0j))
                continue
            if i == 0 and hutch_defl is not None:
                # exact add-back of the projected-out subspace with ONE batch
                # of U-column probes: tr(M_0 U U^H) = sum_i <U_i, M_0 U_i>
                # where M_0 is the full level-0 difference map -- exact for
                # any basis quality, like correction_mode='solve'. The fine
                # solve gets f64 host-residual refinement (the rhs are the
                # deflation vectors themselves; an unrefined f32 solve
                # biases tr1 by ~tol/sigma_min per vector -- see
                # trace/deflation.py solve_refined_host). The coarse term
                # applies the dense inverse, which is safe for low-mode rhs
                # (the rhs aligns with the inverse's dominant directions, so
                # the f32 matmul has no cancellation).
                from deflatedmlmc_schwinger_tpu.mg.diff_op import level_structure
                from deflatedmlmc_schwinger_tpu.trace.deflation import (
                    solve_refined_host,
                )

                k = int(hutch_defl.U.re.shape[1])
                rows = CP(hutch_defl.U.re.T, hutch_defl.U.im.T)
                _, coarse0, restrict0, prolong0 = level_structure(
                    solver, 0, skip_level
                )
                x1 = rows
                if cfg.use_permuted:
                    x1 = shift_rows_down_pair(x1, hier.levels[0].perm_shift)
                    x1 = bblock_apply(hier, 0, x1)   # B_0 = I (kept for form)
                # correction solves run on the sampling solver, as in
                # trace/deflation.py hutchinson_deflation: the cheap basis
                # profile (config.py defl_solver) can leave a near-kernel
                # row unsolved, and no sampling averages that error away
                Z, stalled = solve_refined_host(
                    fine_solver or solver, op, x1, cfg.function_tol,
                    int(cfg.defl_refine_steps), int(cfg.probe_batch),
                )
                check_stalled(
                    int(np.sum(stalled)), k, cfg.max_stalled_frac,
                    "mlmc level-0 deflation correction",
                )
                Uh = (np.asarray(rows.re, np.float64)
                      + 1j * np.asarray(rows.im, np.float64))
                e1 = np.sum(np.conj(Uh) * Z, axis=1)            # (k,)
                xc = restrict0(x1)
                cdi0 = dense_invs.get(_coarse_of(0))
                if coarse0 == coarsest:
                    y = solver.coarsest_solve(xc)
                elif cdi0 is not None:
                    y = cplx.matmul_right(xc, cdi0)
                else:
                    y = solver.solve(xc, cfg.function_tol, level=coarse0).x
                w = prolong0(y)
                e2d = cplx.cdot(rows, w)
                e2 = (np.asarray(e2d.re, np.float64)
                      + 1j * np.asarray(e2d.im, np.float64))
                tr1 = complex(np.sum(e1 - e2))
                defls.append(Deflation(U=hutch_defl.U, tr1=tr1))
                continue
            k = int(cfg.mlmc_deflat_vctrs[i]) if i < len(cfg.mlmc_deflat_vctrs) else 0
            d = mlmc_level_deflation(solver, i, k, cfg, skip_level)
            if mesh is not None and d.U is not None:
                from deflatedmlmc_schwinger_tpu.trace.deflation import (
                    replicate_deflation,
                )

                d = replicate_deflation(d, mesh)
            defls.append(d)

    # ---- rough trace (stoch_trace.py:281-302) ----
    with timer.phase("rough_trace"):
        if hutch_defl is not None:
            # mlmc_fine_deflation already built the full-quality basis
            rough_defl = hutch_defl
        else:
            # the rough trace only sets the stopping denominator, so its
            # basis may be cheaper than the Hutchinson estimator's
            # (config.py: rough_deflat_vctrs / rough_defl_rounds)
            rough_cfg = cfg
            if cfg.rough_deflat_vctrs is not None:
                rough_cfg = rough_cfg.replace(
                    nr_deflat_vctrs=cfg.rough_deflat_vctrs
                )
            rough_defl = hutchinson_deflation(
                op, solver, rough_cfg, fine_solver=fine_solver,
                rounds=cfg.rough_defl_rounds,
            )
        if mesh is not None and rough_defl.U is not None:
            from deflatedmlmc_schwinger_tpu.trace.deflation import replicate_deflation

            rough_defl = replicate_deflation(rough_defl, mesh)
        rough_probes = make_probe_source(probe_source, cfg.rough_seed)
        # padded to the sampling batch shape (see trace/hutchinson.py)
        Br = max(int(cfg.nr_rough_iters), int(cfg.probe_batch))
        X = rough_probes(0, Br, op.n, op.dtype)
        es, _, stall = hutchinson_step_batch(
            op, solver, cfg, rough_defl, X, fine_solver
        )
        n_rough = Br if cfg.rough_batch_full else int(cfg.nr_rough_iters)
        rough_trace = complex(np.mean(es[:n_rough])) + rough_defl.tr1
    check_stalled(int(np.sum(stall)), Br, cfg.max_stalled_frac,
                  "mlmc rough trace")
    log(f"rough trace: {rough_trace:.6f}")

    # ---- output skeleton (stoch_trace.py:308-321) ----
    results = [
        dict(function_iters=0, nr_ests=0, ests_avg=0.0 + 0.0j, ests_dev=0.0,
             level_complexity=0.0, stalled_rows=0)
        for _ in range(nr_levels)
    ]

    f0, f1 = _tolerance_fractions(nr_levels, skip_level)
    for i in range(nr_levels):
        solver.coarsest_lev_iters[i] = 0
        if fine_solver is not None:
            fine_solver.coarsest_lev_iters[i] = 0

    # ---- dense-exact difference levels (zero variance; host f64) ----
    if exact_set:
        with timer.phase("exact_levels"):
            for l in sorted(exact_set):
                t_l = exact_difference_trace(
                    hier, l, skip_level, cfg.use_permuted,
                    Ac_inv=dense_inv_host.get(_coarse_of(l)),
                    Af_inv=dense_inv_host.get(l),
                )
                results[l]["nr_ests"] = 1
                results[l]["ests_avg"] = t_l
                results[l]["ests_dev"] = 0.0
                log(f"level {l}: exact dense difference trace {t_l:.6f}")

    # ---- difference-level sampling loops (stoch_trace.py:348-416) ----
    from deflatedmlmc_schwinger_tpu.utils.checkpoint import EstimatorState

    B = int(cfg.probe_batch)
    state = EstimatorState.load_or_empty(state_ckpt)
    for j in range(nr_levels):
        results[j]["function_iters"] = int(state.iters.get(f"level{j}", 0))
    if mesh is not None:
        from deflatedmlmc_schwinger_tpu.parallel import shard_batch
    if cfg.mlmc_schedule == "adaptive":
        with timer.phase("sampling"):
            _adaptive_sampling(
                solver, cfg, hier, defls, rough_trace, results, state,
                state_ckpt, probe_source, skip_level, fine_solver, mesh, log,
                exact_set=exact_set, dense_invs=dense_invs,
            )
    elif cfg.mlmc_schedule != "sequential":
        raise ValueError(f"unknown mlmc_schedule {cfg.mlmc_schedule!r}")
    else:
        with timer.phase("sampling"):
            for i in range(nr_levels - 1):
                if (skip_level and i == 1) or i in exact_set:
                    continue
                cdi = dense_invs.get(_coarse_of(i))
                tol_fctr = _level_tol_factor(i, nr_levels, f0, f1, skip_level)
                level_trace_tol = cfg.stop_safety * abs(
                    cfg.trace_tol * rough_trace * tol_fctr
                )
                probes = make_probe_source(probe_source, cfg.seed + i)
                key = f"level{i}"
                moments = state.moments.get(key, RunningMoments())
                start = state.next_index.get(key, 0)
                if start:
                    log(f"level {i}: resuming at sample {start} (n={moments.count})")
                n_i = hier.levels[i].n
                # device-resident stopping state on the single-process
                # non-checkpointing path (SURVEY.md section 5.8 item (d)): per
                # batch only a stop bool crosses the host link
                if state_ckpt is None and mesh is None:
                    import jax

                    from deflatedmlmc_schwinger_tpu.trace.stats import (
                        device_moments_init,
                        device_moments_to_host,
                        device_moments_update,
                        device_stop_and_stalled,
                    )

                    rdt = hier.levels[i].op.dtype
                    dm = device_moments_init(rdt)
                    it2_acc = jnp.zeros((), rdt)
                    stall_acc = jnp.zeros((), jnp.int32)
                    upd = jax.jit(device_moments_update)
                    flag_fn = jax.jit(device_stop_and_stalled)
                    coarse = None
                    # flags read TWO batches late (see trace/hutchinson.py):
                    # both later batches stay in flight during the host
                    # round-trip; at worst two extra batches fold into the
                    # moments -- still a valid stop, stderr only shrinks
                    inflight = []
                    stopper = ConfirmedStop(cfg.stop_confirm)
                    while start < cfg.max_nr_ests:
                        # no checkpoint on this path, so `moments` is empty at
                        # entry and dm alone carries the level's statistics
                        X = probes(start, B, n_i, rdt)
                        e, it1, it2, coarse, stall = mlmc_step_batch(
                            solver, cfg, i, defls[i], X, skip_level, fine_solver,
                            gather=False, coarse_dense_inv=cdi,
                        )
                        dm = upd(dm, e.re, e.im, it1)
                        it2_acc = it2_acc + jnp.sum(it2).astype(rdt)
                        stall_acc = stall_acc + jnp.sum(stall).astype(jnp.int32)
                        start += B
                        inflight.append(
                            (start, flag_fn(dm, level_trace_tol,
                                            cfg.min_nr_ests, stall_acc))
                        )
                        if len(inflight) > 2:
                            seen, flag = inflight.pop(0)
                            stop, nstall = (int(v) for v in np.asarray(flag))
                            check_stalled(nstall, seen,
                                          cfg.max_stalled_frac, f"mlmc level {i}")
                            if stopper(bool(stop), seen):
                                break
                    moments = moments.merge(device_moments_to_host(dm))
                    results[i]["function_iters"] += int(np.asarray(dm.iters))
                    nstall = int(np.asarray(stall_acc))
                    check_stalled(nstall, start, cfg.max_stalled_frac,
                                  f"mlmc level {i}")
                    results[i]["stalled_rows"] += nstall
                    if coarse is not None:
                        results[coarse]["function_iters"] += int(np.asarray(it2_acc))
                else:
                    stopper = ConfirmedStop(cfg.stop_confirm)
                    while start < cfg.max_nr_ests:
                        if stopper(
                            should_stop(moments, level_trace_tol, cfg.min_nr_ests),
                            moments.count,
                        ):
                            break
                        X = probes(start, B, n_i, hier.levels[i].op.dtype)
                        if mesh is not None:
                            X = shard_batch(X, mesh, cfg.sample_axis)
                        es, it1, it2, coarse, stall = mlmc_step_batch(
                            solver, cfg, i, defls[i], X, skip_level,
                            fine_solver, coarse_dense_inv=cdi,
                        )
                        moments.update_batch(es)
                        results[i]["function_iters"] += int(np.sum(it1))
                        results[coarse]["function_iters"] += int(np.sum(it2))
                        results[i]["stalled_rows"] += int(np.sum(stall))
                        start += B
                        check_stalled(results[i]["stalled_rows"], moments.count,
                                      cfg.max_stalled_frac, f"mlmc level {i}")
                        if state_ckpt:
                            state.moments[key] = moments
                            state.next_index[key] = start
                            state.iters = {
                                f"level{j}": results[j]["function_iters"]
                                for j in range(nr_levels)
                            }
                            state.save(state_ckpt)
                results[i]["nr_ests"] += moments.count
                results[i]["ests_avg"] = moments.mean + defls[i].tr1
                results[i]["ests_dev"] = moments.std_dev
                log(
                    f"level {i}: {moments.count} ests, trace "
                    f"{results[i]['ests_avg']:.6f}, dev {moments.std_dev:.4f}"
                )

    # ---- exact coarsest trace (stoch_trace.py:418-437) ----
    with timer.phase("coarsest"):
        if hier.levels[-1].n == 1:
            raise Exception(
                "coarsest-level operator is a scalar; refusing the trivial exact trace"
            )
        if not cfg.coarsest_level_directly:
            raise Exception(
                "only the direct (dense-inverse) coarsest-level trace is implemented"
            )
        results[-1]["nr_ests"] += 1
        M = cplx.to_complex(hier.coarsest_inv)
        if cfg.use_permuted:
            Bc = bblock_matrix_host(hier, nr_levels - 1)
            M = M @ Bc
            M = np.roll(M, hier.levels[-1].perm_shift, axis=0)  # Pi_c^T @ M
        results[-1]["ests_avg"] = complex(np.trace(M))
        results[-1]["ests_dev"] = 0.0
    log(f"coarsest exact trace: {results[-1]['ests_avg']:.6f}")

    # ---- complexity model + aggregation (stoch_trace.py:443-467) ----
    nnz = level_nnz(hier)
    for i in range(nr_levels - 1):
        if i in exact_set:
            # dense route: one n^3 inverse per operator (fine + coarse),
            # same charging rule as the exact coarsest below
            n_f = float(hier.levels[i].n)
            n_c = float(hier.levels[_coarse_of(i)].n)
            results[i]["level_complexity"] = n_f ** 3 + n_c ** 3
            continue
        results[i]["level_complexity"] = results[i]["function_iters"] * flops_vcycle(
            nnz, solver.cfg.smooth_iters, i, i
        )
        results[i]["level_complexity"] += nnz[-1] * int(solver.coarsest_lev_iters[i])
        if fine_solver is not None:
            results[i]["level_complexity"] += nnz[-1] * int(
                fine_solver.coarsest_lev_iters[i]
            )
    n_c = hier.levels[-1].n
    results[-1]["level_complexity"] = float(n_c) ** 3 + results[-1][
        "function_iters"
    ] * float(n_c) ** 2

    # aggregate standard error of the total trace: the level estimates are
    # independent, so stderr(sum) = sqrt(sum_l dev_l^2 / n_l) over the
    # stochastic levels (the exact coarsest contributes zero variance). The
    # reference reports per-level deviations only (utils.py:36-56).
    agg_stderr = sqrt(
        sum(
            r["ests_dev"] ** 2 / r["nr_ests"]
            for r in results[:-1]
            if r["nr_ests"] > 0
        )
    )
    out = dict(
        nr_levels=nr_levels,
        results=results,
        rough_trace=rough_trace,
        std_dev=agg_stderr,
        trace=sum(r["ests_avg"] for r in results),
        total_complexity=sum(r["level_complexity"] for r in results),
        stalled_rows=sum(r["stalled_rows"] for r in results),
        timer=timer,
    )
    return out
