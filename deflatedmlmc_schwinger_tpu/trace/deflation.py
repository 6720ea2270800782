"""Deflation pre-computations for both estimators (pair-native).

Reference: utils.py:130-201. Semantics preserved exactly:
  * Hutchinson: eigenpairs of the Hermitian Q = gamma3 A nearest zero; the
    deflation basis is U = Pi gamma3 V sign(Lambda) (the value the reference
    returns and projects probes against, utils.py:145-155,199) and the exact
    low-rank term is tr1 = tr(U^H V |Lambda|^{-1}) (utils.py:173).
  * MLMC level l: top eigenpairs of the Hermitian difference operator
    Q_l = f_l o gamma3; probe projector basis is V = gamma3 W, U = W sign,
    tr1 = tr(U^H V |Lambda|) for defl_type 'exact' (utils.py:174-189) or the
    explicitly applied f_l for 'inexact_01'.

Changes from the reference (flagged where behavior could differ):
  * the eigensolver is MG-driven inverse subspace iteration (Hutchinson) /
    block power iteration (MLMC) instead of ARPACK -- solvers/eigs.py;
  * correction_mode='solve' computes tr1 = sum_i <U_i, A^{-1} Pi^T U_i> with
    k extra MG solves, which is EXACT for any basis quality (the reference's
    eigendecomposition formula is exact only for converged eigenpairs); the
    reference formula is available as correction_mode='eig'.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu.mg.diff_op import make_diff_op, make_diff_op_Q
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.dirac import gamma3_pair
from deflatedmlmc_schwinger_tpu.solvers.eigs import (
    _apply_cols,
    subspace_iteration_largest,
)


@dataclasses.dataclass
class Deflation:
    """Deflation data for one estimator/level. U is the probe projector
    basis as a CP pair of (n, k) arrays (device)."""

    U: Optional[CP]
    tr1: complex
    values: Optional[np.ndarray] = None
    resnorms: Optional[np.ndarray] = None
    aux_V: Optional[CP] = None   # MLMC: the reference's Ux (for inexact_03)
    proj_B: Optional[CP] = None  # inexact_03: (U^H A V)^{-1}, precomputed
    stalled_rows: int = 0        # correction solves that ended above tol


def _device_basis(V: np.ndarray, rdtype) -> CP:
    return CP(
        jnp.asarray(np.ascontiguousarray(V.real).astype(np.dtype(rdtype))),
        jnp.asarray(np.ascontiguousarray(V.imag).astype(np.dtype(rdtype))),
    )


def solve_refined_host(basis_solver, op, rhs: CP, tol: float, steps: int,
                       pad_to: int):
    """Solve A Z = rhs for k pair rows with ``steps`` rounds of f64
    host-residual iterative refinement; returns (Z complex128 host (k, n),
    stalled bool (k,) of the first pass).

    The device solves run at the f32-attainable ``tol``; after each, the
    residual of the ACCUMULATED f64 solution is recomputed EXACTLY on the
    host (ops/dirac.py stencil_matvec_host) and one more device solve adds
    the correction. Final solution error O(tol^2/sigma_min) instead of the
    single-solve O(tol/sigma_min) -- which matters precisely for the
    low-mode correction right-hand sides (config.py defl_refine_steps).

    Rows are cyclically padded to ``pad_to`` so every solve reuses the
    sampling program's XLA shape. Refinement is skipped (device result
    returned as-is) when the solver's mesh spans processes (the solution is
    not host-addressable) or the operator has no host coefficient form."""
    import jax.numpy as jnp

    from deflatedmlmc_schwinger_tpu.ops.dirac import stencil_matvec_host

    k = rhs.re.shape[0]

    def pad(x: CP) -> CP:
        if k < pad_to:
            idx = jnp.arange(pad_to) % k
            return CP(x.re[idx], x.im[idx])
        return x

    res = basis_solver.solve(pad(rhs), tol)
    stalled = np.asarray(res.stalled)[:k]
    Z = (np.asarray(res.x.re[:k], np.float64)
         + 1j * np.asarray(res.x.im[:k], np.float64))
    mesh = getattr(basis_solver, "mesh", None)
    if mesh is not None:
        from deflatedmlmc_schwinger_tpu.parallel.mesh import spans_processes

        if spans_processes(mesh):
            steps = 0
    if not hasattr(op, "coeffs"):
        steps = 0
    rdt = op.dtype
    if steps:
        C = (np.asarray(op.coeffs.re, np.float64)
             + 1j * np.asarray(op.coeffs.im, np.float64))
        bh = (np.asarray(rhs.re, np.float64)
              + 1j * np.asarray(rhs.im, np.float64))
        for _ in range(int(steps)):
            r = bh - stencil_matvec_host(C, Z, op.nx, op.nt)
            rp = CP(jnp.asarray(r.real.astype(np.dtype(rdt))),
                    jnp.asarray(r.imag.astype(np.dtype(rdt))))
            dres = basis_solver.solve(pad(rp), tol)
            Z = Z + (np.asarray(dres.x.re[:k], np.float64)
                     + 1j * np.asarray(dres.x.im[:k], np.float64))
    return Z, stalled


def hutchinson_deflation(
    op,
    solver: MGSolver,
    cfg: TraceConfig,
    *,
    correction_mode: str = "solve",
    rounds: Optional[int] = None,
    seed_offset: int = 101,
    fine_solver=None,
) -> Deflation:
    """Deflation basis + exact correction for deflated Hutchinson.

    ``fine_solver``: optional lattice-sharded ShardedMGSolver -- the basis
    solves then run the domain-decomposed SPMD program with the basis block
    dimension sharded over the samples axis (SURVEY.md P4: deflation-setup
    parallelism). Falls back to the replicated solver when the basis size
    does not divide over the mesh."""
    if rounds is None:
        rounds = int(cfg.defl_subspace_rounds)
    k = int(cfg.nr_deflat_vctrs)
    if k == 0:
        return Deflation(U=None, tr1=0.0 + 0.0j)
    from deflatedmlmc_schwinger_tpu.ops.dirac import (
        shift_rows_down_pair,
        shift_rows_up_pair,
    )
    from deflatedmlmc_schwinger_tpu.solvers.eigs import (
        inverse_iteration_smallest_device,
    )

    rdtype = op.dtype
    # ctx-style matvec (ops/dirac.py gamma3_matvec_ctx): ONE stable callable
    # keys the lru-cached eigensolver kernels, so repeated deflation calls
    # in a process (MLMC fine-deflation + rough trace + Hutchinson) reuse
    # the traced Ritz programs instead of re-tracing them, and the operator
    # tensors ride as jit arguments (small executables, fast loads)
    from deflatedmlmc_schwinger_tpu.ops.dirac import gamma3_matvec_ctx

    solve_tol = cfg.solver.effective_tol(
        cfg.defl_eigvs_tol_Hutch, cplx.complex_dtype(rdtype)
    )
    # P4: shard the basis block over the samples axis when it divides (the
    # m basis rows ride the solver's batch dimension); pad m up to a shard
    # multiple so every device carries an equal slice
    m = (int(cfg.defl_buffer) if cfg.defl_buffer is not None
         else max(k + 2, int(round(1.25 * k))))
    m = max(m, k)
    basis_solver = solver
    correction_solver = solver
    if cfg.defl_solver is not None:
        # setup-specific solver profile (config.py defl_solver): deflation
        # solves are stall-cutoff-bound near-kernel systems whose cost
        # scales with the per-iteration price, not the iteration count.
        # derived() caches the instance so every deflation call in a
        # process reuses ONE loaded executable family (mg/cycle.py).
        basis_solver = solver.derived(cfg.defl_solver)
    if fine_solver is not None:
        nsh = fine_solver.mesh.shape[fine_solver.sample_axis]
        if k % nsh == 0:
            m = ((m + nsh - 1) // nsh) * nsh
            basis_solver = correction_solver = fine_solver

    def apply_Qinv(v: CP) -> CP:  # Q^{-1} v = A^{-1} gamma3 v
        return basis_solver.solve(gamma3_pair(v), solve_tol).x

    # device-resident: the (k, n) basis never leaves the device; only k x k
    # projections, eigenvalues, and the tr1 scalar cross the host link
    eig = inverse_iteration_smallest_device(
        gamma3_matvec_ctx, apply_Qinv, op.n, k, rdtype=rdtype,
        seed=cfg.seed + seed_offset,
        rounds=rounds, tol=cfg.defl_eigvs_tol_Hutch, buffer=m,
        warm_filter_degree=int(cfg.defl_warm_filter_degree), ctx=op,
    )
    theta = eig.values                      # signed eigenvalues of Q (host)
    Vr = eig.vectors                        # device (k, n) rows
    sgn = jnp.asarray(np.sign(theta).astype(np.dtype(rdtype)))[:, None]
    # U = Pi gamma3 V sign (reference: utils.py:145-155)
    Ur = cplx.scale_real(gamma3_pair(Vr), sgn)
    d = solver.hier.levels[0].perm_shift
    if cfg.use_permuted and d:
        Ur = shift_rows_up_pair(Ur, d)      # Pi @ U (rows of U = cols of basis)

    if correction_mode == "eig":
        # reference formula (utils.py:173): tr(U^H V |Lambda|^{-1}) -- only
        # the diagonal is needed: sum_i <U_i, V_i> / |theta_i|
        diag = cplx.cdot(Ur, Vr)            # (k,) pair
        dc = np.asarray(diag.re) + 1j * np.asarray(diag.im)
        tr1 = complex(np.sum(dc / np.abs(theta)))
    elif correction_mode == "solve":
        # exact: tr(A^{-1} Pi^T U U^H) = sum_i <U_i, A^{-1} Pi^T U_i>.
        # The rhs are the deflation vectors -- the hardest systems in the
        # run -- and no sampling averages their error away, so they run on
        # the SAMPLING solver (cfg.solver), not the cheap basis profile:
        # on the 128^2 config the depth-4 defl_solver left one of these
        # rows at relative residual ~1 and biased tr1 by 17 (76% of the
        # trace), while the sampling solver met 5e-4 on every row but one
        # (5.4e-4). Rows that still end above tol are counted into the
        # result's stalled_rows. The f32 solves can also take
        # f64 host-residual refinement (config.py defl_refine_steps). The
        # rows pad to the sampling batch size, so the solve reuses that
        # XLA program.
        rhs = Ur
        if cfg.use_permuted and d:
            rhs = shift_rows_down_pair(rhs, d)  # Pi^T @ U
        Z, stalled = solve_refined_host(
            correction_solver, op, rhs, cfg.function_tol,
            int(cfg.defl_refine_steps), int(cfg.probe_batch),
        )
        Uh = (np.asarray(Ur.re, np.float64)
              + 1j * np.asarray(Ur.im, np.float64))
        tr1 = complex(np.sum(np.conj(Uh) * Z))
    else:
        raise ValueError(correction_mode)
    return Deflation(
        U=Ur.T, tr1=tr1, values=theta, resnorms=eig.resnorms,
        stalled_rows=int(np.sum(stalled)) if correction_mode == "solve" else 0,
    )


def mlmc_level_deflation(
    solver: MGSolver,
    level: int,
    k: int,
    cfg: TraceConfig,
    skip_level: bool,
    *,
    rounds: int = 10,
) -> Deflation:
    """Per-difference-level deflation for MLMC (reference: utils.py:141-189,
    stoch_trace.py:246-274). Each operator application costs two MG solves at
    diff_lev_op_tol."""
    if k == 0:
        return Deflation(U=None, tr1=0.0 + 0.0j)
    n = solver.hier.levels[level].n
    rdtype = solver.hier.levels[level].op.dtype
    qd = make_diff_op_Q(solver, level, cfg.diff_lev_op_tol, skip_level)
    eig = subspace_iteration_largest(
        qd, n, k, rdtype=rdtype, seed=cfg.seed + 202 + level, rounds=rounds,
        tol=cfg.defl_eigvs_tol_MLMC,
    )
    theta = eig.values
    W = eig.vectors                          # host (n, k)
    sgn = np.sign(theta)
    Uref = W * sgn[None, :]                  # the reference's Ux (utils.py:148-149)
    half = n // 2
    V = np.concatenate([W[:half], -W[half:]], axis=0)  # gamma3 W (utils.py:157)

    proj_B = None
    if cfg.defl_type == "exact":
        small = (Uref.conj().T @ V) * np.abs(theta)[None, :]
        tr1 = complex(np.trace(small))
    elif cfg.defl_type == "inexact_01":
        f = make_diff_op(solver, level, cfg.diff_lev_op_tol, skip_level)
        Vbuff = _apply_cols(f, V, rdtype)
        tr1 = complex(np.trace(V.conj().T @ Vbuff))
    elif cfg.defl_type == "inexact_02":
        raise NotImplementedError("deflation type inexact_02 under construction")
    elif cfg.defl_type == "inexact_03":
        # oblique projector x - V (U^H A V)^{-1} U^H A x (reference:
        # utils.py:269-276): the k x k system is fixed per level, so AV and
        # its small inverse are precomputed HERE, once -- not per sampling
        # batch on the hot path.
        tr1 = 0.0 + 0.0j
        Af = solver.matvec(level)
        AV = _apply_cols(Af, V, rdtype)
        proj_B = _device_basis(np.linalg.inv(Uref.conj().T @ AV), rdtype)
    else:
        raise ValueError(f"unknown deflation type {cfg.defl_type!r}")
    return Deflation(
        U=_device_basis(V, rdtype),
        tr1=tr1,
        values=theta,
        resnorms=eig.resnorms,
        aux_V=_device_basis(Uref, rdtype),
        proj_B=proj_B,
    )


def replicate_deflation(defl: Deflation, mesh) -> Deflation:
    """Replicate the device-resident deflation arrays over a mesh (SURVEY.md
    P4: basis computed once, broadcast everywhere). Without this the basis
    sits on one device and every projector application drags the sharded
    probe batch there."""
    from deflatedmlmc_schwinger_tpu.parallel.mesh import replicate

    return dataclasses.replace(
        defl,
        **{
            f: replicate(getattr(defl, f), mesh)
            for f in ("U", "aux_V", "proj_B")
            if getattr(defl, f) is not None
        },
    )


def deflate(x: CP, U: Optional[CP]) -> CP:
    """x - U (U^H x) on (B, n) pair batches (fused tall-skinny real matmuls,
    reference: utils.py:224,266)."""
    if U is None:
        return x
    c = cplx.matmul_right_conjT(x, U)        # (B, k) = x @ conj(U)
    return x - cplx.matmul_right(c, U)       # c @ U.T
