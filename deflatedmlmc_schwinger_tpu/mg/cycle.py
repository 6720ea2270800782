"""The V-cycle and the multigrid-preconditioned FGMRES solver (pair form).

Reference semantics (multigrid.py:347-447):
  * ``MG.solve`` = flexible GMRES on the level operator, right-preconditioned
    by one V-cycle, maxiter = min(N, 1000);
  * V-cycle: pre-smooth (Krylov smoother from zero initial guess), residual,
    restrict; dense precomputed inverse on the coarsest level;
    prolongate-correct, residual, post-smooth;
  * solves may start from ANY level (``level_nr`` retargeting) -- the MLMC
    estimator reuses the hierarchy as its level structure.

Design: everything is jitted, batched over probe vectors, and runs on
(re, im) pairs; the smoother is a fixed-iteration GMRES on a static-size
Arnoldi whose tiny least-squares solve is an unrolled complex Cholesky in
pair scalar arithmetic. Closures are
cached per starting level so XLA compiles each (level, batch-shape)
combination exactly once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import jax.numpy as jnp
import numpy as np
from jax import lax

from deflatedmlmc_schwinger_tpu.config import SolverConfig
from deflatedmlmc_schwinger_tpu.mg.hierarchy import Hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.solvers.fgmres import (
    FGMRESResult,
    fgmres,
    pdot,
    pnorm,
)


def _solve_hpd_small(A: list, b: list, m: int):
    """Solve the m x m Hermitian positive-definite system A y = b for a batch
    of CP scalars (A[i][j], b[i] are (B,) pairs), by unrolled Cholesky.
    m is the smoother depth (2-6), so the unrolled op count is trivial."""
    L = [[None] * m for _ in range(m)]
    d = [None] * m  # real diagonals
    eps = 1e-30
    for i in range(m):
        for j in range(i):
            s = A[i][j]
            for k2 in range(j):
                s = s - cplx.cmul(L[i][k2], L[j][k2].conj())
            L[i][j] = CP(s.re / d[j], s.im / d[j])
        acc = A[i][i].re
        for k2 in range(i):
            acc = acc - cplx.cabs2(L[i][k2])
        d[i] = jnp.sqrt(jnp.maximum(acc, eps))
        L[i][i] = None  # diagonal kept separately (real)
    # forward: L z = b  (unit handling with real diag d)
    z = [None] * m
    for i in range(m):
        s = b[i]
        for k2 in range(i):
            s = s - cplx.cmul(L[i][k2], z[k2])
        z[i] = CP(s.re / d[i], s.im / d[i])
    # backward: L^H y = z
    y = [None] * m
    for i in reversed(range(m)):
        s = z[i]
        for k2 in range(i + 1, m):
            s = s - cplx.cmul(L[k2][i].conj(), y[k2])
        y[i] = CP(s.re / d[i], s.im / d[i])
    return y


def gmres_smoother(matvec: Callable, r: CP, iters: int, axis_name=None) -> CP:
    """k-step GMRES from a zero initial guess (the reference's
    ``lgmres(tol=1e-20, maxiter=smooth_iters)`` smoothing role,
    multigrid.py:392-394). Static iteration count, batched, pair-native.
    ``axis_name``: psum reductions over that mesh axis when the vector axis
    is lattice-sharded inside shard_map."""
    B = r.re.shape[0]
    m = iters
    rdtype = r.re.dtype
    eps = jnp.finfo(rdtype).tiny
    beta = pnorm(r, axis_name)
    Vs = [cplx.scale_real(r, 1.0 / jnp.maximum(beta, eps)[:, None])]
    # H as python lists of (B,) pair scalars: H[i][j]
    H = [[None] * m for _ in range(m + 1)]
    for j in range(m):
        w = matvec(Vs[j])
        for i in range(j + 1):
            hij = pdot(Vs[i], w, axis_name)
            H[i][j] = hij
            w = w - cplx.cmul(CP(hij.re[:, None], hij.im[:, None]), Vs[i])
        hn = pnorm(w, axis_name)
        H[j + 1][j] = CP(hn, jnp.zeros_like(hn))
        Vs.append(cplx.scale_real(w, 1.0 / jnp.maximum(hn, eps)[:, None]))
    # normal equations: (H^H H) y = H^H (beta e1)
    zero = jnp.zeros((B,), rdtype)
    czero = CP(zero, zero)
    A = [[czero for _ in range(m)] for _ in range(m)]
    rhs = [czero for _ in range(m)]
    for a in range(m):
        for b_ in range(m):
            s = czero
            for i in range(min(a, b_) + 2):
                ha = H[i][a] if i <= a + 1 and H[i][a] is not None else None
                hb = H[i][b_] if i <= b_ + 1 and H[i][b_] is not None else None
                if ha is not None and hb is not None:
                    s = s + cplx.cmul_conj(ha, hb)
            A[a][b_] = s
        # rhs_a = conj(H[0][a]) * beta
        h0a = H[0][a]
        rhs[a] = CP(h0a.re * beta, -h0a.im * beta)
    y = _solve_hpd_small(A, rhs, m)
    out = cplx.czeros(r.re.shape, rdtype)
    for j in range(m):
        out = out + cplx.cmul(CP(y[j].re[:, None], y[j].im[:, None]), Vs[j])
    return out


def gmres_poly_roots(matvec: Callable, n: int, rdtype, m: int, seed: int = 29):
    """Harmonic Ritz values of a short Arnoldi run -- the roots of the
    m-step GMRES residual polynomial. Used by the 'poly' smoother: applying
    prod_k (I - A/theta_k) reproduces one m-step GMRES smoothing application
    with ZERO inner products (host setup cost: m matvecs, once per level)."""
    import numpy as np

    from deflatedmlmc_schwinger_tpu.solvers.eigs import _apply_cols

    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    V = np.zeros((n, m + 1), dtype=complex)
    H = np.zeros((m + 1, m), dtype=complex)
    V[:, 0] = v / np.linalg.norm(v)
    for j in range(m):
        w = _apply_cols(matvec, V[:, j : j + 1], rdtype)[:, 0]
        for i in range(j + 1):
            H[i, j] = np.vdot(V[:, i], w)
            w = w - H[i, j] * V[:, i]
        H[j + 1, j] = np.linalg.norm(w)
        V[:, j + 1] = w / max(H[j + 1, j].real, 1e-300)
    Hm = H[:m, :m]
    f = np.linalg.solve(Hm.conj().T, np.eye(m)[:, -1])
    theta = np.linalg.eigvals(Hm + (abs(H[m, m - 1]) ** 2) * np.outer(f, np.eye(m)[-1]))
    # Leja ordering for numerically stable application
    order = [int(np.argmax(np.abs(theta)))]
    for _ in range(m - 1):
        rest = [i for i in range(m) if i not in order]
        prod = [np.prod([abs(theta[i] - theta[o]) for o in order]) for i in rest]
        order.append(rest[int(np.argmax(prod))])
    return theta[order]


def poly_smoother(matvec: Callable, r: CP, roots, with_residual: bool = False):
    """x = p(A) r with p the fixed GMRES residual-polynomial inverse:
    x += cur/theta_k ; cur -= A cur/theta_k. No reductions.

    The recurrence keeps cur = r - A x, so the smoothed residual is free:
    ``with_residual`` returns (x, r - A x) using m matvecs; otherwise the
    final operator application is skipped (m-1 matvecs) and x alone returns."""
    x = None
    cur = r
    for k, th in enumerate(roots):
        inv = 1.0 / th
        ir, ii = float(inv.real), float(inv.imag)
        step = CP(ir * cur.re - ii * cur.im, ir * cur.im + ii * cur.re)
        x = step if x is None else x + step
        if k == len(roots) - 1 and not with_residual:
            break
        cur = cur - matvec(step)
    if with_residual:
        return x, cur
    return x


def residual(op, b: CP, x: CP) -> CP:
    """r = b - A x."""
    return b - op.matvec(x)


class PolySmoother:
    """GMRES-residual-polynomial smoother (zero inner products).

    ``smooth``/``smooth_residual`` take the LEVEL OPERATOR (which may be a
    traced pytree -- MGSolver passes the hierarchy as a jit argument so no
    operator tensors are baked into executables): a fine stencil level on
    the GPU runs one kernel pass per root, any other level the plain matvec
    recurrence of ``poly_smoother``. The interface is shared with
    GmresSmoother so build_v_cycle is smoother-agnostic; the lattice-sharded
    solve smooths its level 0 with the raw ``poly_smoother`` over the halo
    matvec and uses these objects only on replicated coarse levels."""

    def __init__(self, roots):
        self.roots = tuple(complex(t) for t in roots)

    def smooth(self, op, r: CP) -> CP:
        if _fused(op):
            return _poly_smoother_kernel(op, r, self.roots, False)
        return poly_smoother(op.matvec, r, self.roots)

    def smooth_residual(self, op, b: CP):
        if _fused(op):
            return _poly_smoother_kernel(op, b, self.roots, True)
        return poly_smoother(op.matvec, b, self.roots, with_residual=True)


def _fused(op) -> bool:
    from deflatedmlmc_schwinger_tpu.ops import stencil_kernel
    from deflatedmlmc_schwinger_tpu.ops.dirac import PairStencilOperator

    return (isinstance(op, PairStencilOperator)
            and stencil_kernel.use_kernel(op.nx, op.nt))


def _poly_smoother_kernel(op, r: CP, roots, with_residual: bool, **kernel_kw):
    """``poly_smoother`` on a fine stencil level with one kernel pass per
    root (ops/stencil_kernel.py); the last root's x update alone is a plain
    elementwise op when no residual is wanted."""
    from deflatedmlmc_schwinger_tpu.ops.stencil_kernel import poly_root_update

    x, cur = None, r
    last = len(roots) - 1
    for k, th in enumerate(roots):
        if k == last and not with_residual:
            inv = 1.0 / th
            step = CP(inv.real * cur.re - inv.imag * cur.im,
                      inv.real * cur.im + inv.imag * cur.re)
            return step if x is None else x + step
        x, cur = poly_root_update(op.coeffs, cur, x, 1.0 / th, op.nx, op.nt,
                                  **kernel_kw)
    return x, cur


class GmresSmoother:
    """Adaptive fixed-step GMRES smoothing (reference lgmres semantics)."""

    def __init__(self, iters: int, axis_name=None):
        self.iters = int(iters)
        self.axis_name = axis_name

    def smooth(self, op, r: CP) -> CP:
        return gmres_smoother(op.matvec, r, self.iters, self.axis_name)

    def smooth_residual(self, op, b: CP):
        x = self.smooth(op, b)
        return x, b - op.matvec(x)


def build_v_cycle(levels, coarsest_inv: CP, smoothers,
                  with_residual: bool = False) -> Callable:
    """V-cycle closure over an explicit level tuple (pair-native): descend
    with smooth+residual/restrict, dense precomputed inverse on the coarsest,
    ascend with prolong-correct/residual/post-smooth (reference:
    multigrid.py:369-447). ``smoothers[i]`` pairs with ``levels[i]`` and is a
    PolySmoother/GmresSmoother-like object.

    ``with_residual``: also return the top level's final residual
    b - A x_out (free from the post-smoother's recurrence) -- the caller's
    next operator application is then just b - r (MGSolver.precond_matvec).

    Standalone so the lattice-sharded fine-level solve can reuse the SAME
    coarse-cycle code inside shard_map (parallel/sharded_solve.py): the
    level-0 V-cycle factors as smooth0 + P0 . v_cycle(levels[1:]) . R0 +
    post-smooth0."""

    def v_cycle(b: CP):
        bs = [b]
        xs = []
        for lev, sm in zip(levels[:-1], smoothers):
            x, r = sm.smooth_residual(lev.op, bs[-1])
            xs.append(x)
            bs.append(lev.P.apply_adjoint(r))
        xc = cplx.matmul_right(bs[-1], coarsest_inv)
        out_res = None
        n_up = len(levels) - 1
        for idx, (lev, sm, x, bf) in enumerate(
            zip(levels[-2::-1], smoothers[::-1], xs[::-1], bs[-2::-1])
        ):
            x = x + lev.P.apply(xc)
            r = residual(lev.op, bf, x)
            if with_residual and idx == n_up - 1:
                dx, out_res = sm.smooth_residual(lev.op, r)
                x = x + dx
            else:
                x = x + sm.smooth(lev.op, r)
            xc = x
        if with_residual:
            return xc, out_res
        return xc

    return v_cycle


class MGSolver:
    """Multigrid-preconditioned batched solver over a Hierarchy (pair-native).

    The analog of the reference's MG class solve path; carries the same
    bookkeeping (outer iteration counts, coarsest-level applications,
    reference: multigrid.py:349-352, 419-423)."""

    def __init__(self, hier: Hierarchy, cfg: Optional[SolverConfig] = None):
        self.hier = hier
        self.cfg = cfg or SolverConfig()
        self._matvecs: Dict[int, Callable] = {}
        self._preconds: Dict[int, Callable] = {}
        self._poly_roots: Dict[int, object] = {}
        self.num_iters = 0
        self.coarsest_lev_iters = [0] * hier.nr_levels
        self.total_solve_calls = 0
        self._derived: list = []

    def derived(self, cfg: Optional[SolverConfig]) -> "MGSolver":
        """A solver over the SAME hierarchy with a different SolverConfig,
        cached per config on this instance.

        The fgmres jit key includes the (static) matvec/precond callables,
        which live in this object's closure caches -- so a FRESH MGSolver
        per setup phase would retrace and recompile the whole program family
        on every call. Handing back the same cached instance makes every
        estimator in a process share one set of compiled executables per
        config."""
        if cfg is None or cfg == self.cfg:
            return self
        for c, s in self._derived:
            if c == cfg:
                return s
        s = MGSolver(self.hier, cfg)
        self._derived.append((cfg, s))
        return s

    def _roots_for(self, level_index: int):
        if level_index not in self._poly_roots:
            # precomputed at host setup -- zero device matvecs; both the
            # primary and the defl-solver depth are stored (poly_roots /
            # poly_roots_extra), so the lazy device-Arnoldi fallback below
            # only fires for hierarchies built without host setup
            for pre in (self.hier.poly_roots,
                        getattr(self.hier, "poly_roots_extra", None)):
                if (pre is not None and level_index < len(pre)
                        and len(pre[level_index]) == self.cfg.smooth_iters):
                    self._poly_roots[level_index] = np.asarray(pre[level_index])
                    break
            else:
                import jax

                lev = self.hier.levels[level_index]
                self._poly_roots[level_index] = gmres_poly_roots(
                    jax.jit(lev.op.matvec), lev.n, lev.op.dtype,
                    self.cfg.smooth_iters,
                )
        return self._poly_roots[level_index]

    # -- cached closures ----------------------------------------------------
    def matvec(self, level: int = 0) -> Callable:
        if level not in self._matvecs:
            op = self.hier.levels[level].op
            self._matvecs[level] = op.matvec
        return self._matvecs[level]

    # ctx-style twins: the hierarchy arrives as the fgmres ``ctx`` argument
    # (solvers/fgmres.py), so level tensors are jit ARGUMENTS -- executables
    # stay small (no baked hierarchy constants) and are reused across
    # hierarchies of identical shape. The plain
    # closures above remain for external composition (bench loops, eigs).
    def _matvec_ctx(self, level: int) -> Callable:
        key = ("mvctx", level)
        if key not in self._matvecs:
            def mv(hier, v):
                return hier.levels[level].op.matvec(v)

            self._matvecs[key] = mv
        return self._matvecs[key]

    def _precond_ctx(self, level: int) -> Callable:
        key = ("pcctx", level)
        if key not in self._preconds:
            smoothers = self._smoothers(level)

            def pc(hier, b):
                return build_v_cycle(
                    hier.levels[level:], hier.coarsest_inv, smoothers
                )(b)

            self._preconds[key] = pc
        return self._preconds[key]

    def _smoothers(self, level: int):
        levels = self.hier.levels[level:]
        if self.cfg.smoother == "poly":
            return [
                PolySmoother(self._roots_for(level + i))
                for i in range(len(levels) - 1)
            ]
        return [GmresSmoother(self.cfg.smooth_iters)] * (len(levels) - 1)

    def precond(self, level: int = 0) -> Callable:
        if level not in self._preconds:
            self._preconds[level] = build_v_cycle(
                self.hier.levels[level:], self.hier.coarsest_inv,
                self._smoothers(level),
            )
        return self._preconds[level]

    def precond_matvec(self, level: int = 0) -> Callable:
        """(z, A z) in one pass: the V-cycle emits its own final residual r =
        v - A z (free from the post-smoother recurrence), so the outer
        Arnoldi's operator application is the subtraction v - r instead of a
        full stencil matvec (solvers/fgmres.py ``matvec_precond``).

        NOT wired into ``solve``: on an earlier accelerator XLA scheduled
        the tuple-returning preconditioner inside the Arnoldi while-loop far
        slower than the separate precond+matvec pair; on the GPU it is not
        measured. Kept (and tested) as the algebraically-equal fused form."""
        key = ("pm", level)
        if key not in self._preconds:
            vc = build_v_cycle(
                self.hier.levels[level:], self.hier.coarsest_inv,
                self._smoothers(level), with_residual=True,
            )

            def pm(v: CP):
                z, r = vc(v)
                return z, v - r

            self._preconds[key] = pm
        return self._preconds[key]

    # -- solves -------------------------------------------------------------
    def solve(
        self,
        b: Union[CP, jnp.ndarray, np.ndarray],
        tol: float,
        *,
        level: int = 0,
        precondition: bool = True,
        max_restarts: Optional[int] = None,
    ) -> FGMRESResult:
        """Solve A_level x = b for a batch b of shape (B, n_level).

        b may be a CP pair (device path) or a complex array (host/test
        convenience; converted once at this boundary)."""
        if not isinstance(b, CP):
            b = cplx.from_complex(np.asarray(b))
            b = b.astype(self.hier.levels[level].op.dtype)
        tol_eff = self.cfg.effective_tol(tol, cplx.complex_dtype(b.re.dtype))
        res = fgmres(
            self._matvec_ctx(level),
            b,
            tol=tol_eff,
            restart=self.cfg.restart,
            max_restarts=max_restarts if max_restarts is not None else self.cfg.max_restarts,
            precond=self._precond_ctx(level) if precondition else None,
            stall_ratio=self.cfg.stall_ratio,
            stall_cycles=self.cfg.stall_cycles,
            ctx=self.hier,
        )
        # kept as lazy device scalars -- a per-call int() would force a
        # device sync on the hot path; reporting converts at read time.
        # NOTE the V-cycle count is approximated by the max over batch rows
        # (batched solves share Arnoldi steps until all rows converge), and
        # coarsest applications are charged one per outer iteration -- the
        # same charging rule as the reference (multigrid.py:349-352,419-423)
        # up to batching.
        iters = jnp.max(res.iters)
        self.num_iters = iters
        self.total_solve_calls += 1
        self.coarsest_lev_iters[level] = self.coarsest_lev_iters[level] + iters
        return res

    def coarsest_solve(self, b: CP) -> CP:
        """Directly apply the precomputed dense coarsest inverse
        (reference: multigrid.py:413-414)."""
        self.coarsest_lev_iters[self.hier.nr_levels - 1] += 1
        return cplx.matmul_right(b, self.hier.coarsest_inv)
