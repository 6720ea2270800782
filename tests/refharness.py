"""Import-and-drive harness for the reference code at /root/reference.

Used ONLY by matched-seed parity tests and artifact runs (docs/PARITY.md):
the reference is the NumPy/SciPy oracle for matched-seed agreement. Two shims make it runnable on this image
(exactly the two the survey used, SURVEY.md intro):

  * ``pyamg`` is not installed -- a pure-Python flexible GMRES stands in for
    ``pyamg.krylov.fgmres`` (the only pyamg symbol the reference uses,
    reference multigrid.py:4,362): right-preconditioned, no restart,
    ||r|| < tol*||b|| stopping, (x, exitcode) return, per-iteration callback.
  * SciPy >= 1.14 renamed ``lgmres(tol=)`` -> ``rtol`` -- a thin wrapper is
    monkeypatched onto scipy.sparse.linalg BEFORE the reference imports it
    (reference multigrid.py:393,438 passes tol=1e-20).

The reference reads its .mat files relative to the CWD and keys the
schwinger16 gamma3 fixup on the exact string 'schwinger16.mat'
(reference matrix.py:24-27), so loading chdirs into /root/reference.
"""

from __future__ import annotations

import importlib
import os
import sys
import types
from typing import Dict

import numpy as np

REF_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REF_DIR) and os.path.exists(
        os.path.join(REF_DIR, "stoch_trace.py")
    )


def pure_fgmres(A, b, tol=1e-5, M=None, callback=None, maxiter=None,
                x0=None, restrt=None):
    """Flexible GMRES stand-in for pyamg.krylov.fgmres (full Arnoldi, no
    restart -- the reference caps maxiter at min(N, 1000),
    reference multigrid.py:353-362). The small least-squares problem is
    re-solved per iteration (j^2 host work, negligible next to the V-cycle
    preconditioner applications)."""
    n = b.shape[0]
    mi = int(maxiter) if maxiter else min(n, 1000)
    matvec = A.matvec if hasattr(A, "matvec") else (lambda v: A @ v)
    psolve = (M.matvec if M is not None else (lambda v: v))
    dtype = np.result_type(b.dtype, np.complex128)
    bnrm = np.linalg.norm(b)
    if bnrm == 0.0:
        return np.zeros_like(b), 0
    V = np.zeros((mi + 1, n), dtype=dtype)
    Z = np.zeros((mi, n), dtype=dtype)
    H = np.zeros((mi + 1, mi), dtype=dtype)
    r = b.astype(dtype)
    beta = np.linalg.norm(r)
    V[0] = r / beta
    y = None
    k = 0
    for j in range(mi):
        Z[j] = psolve(V[j])
        w = matvec(Z[j]).astype(dtype)
        for i in range(j + 1):
            H[i, j] = np.vdot(V[i], w)
            w = w - H[i, j] * V[i]
        h = np.linalg.norm(w)
        H[j + 1, j] = h
        if h > 0:
            V[j + 1] = w / h
        k = j + 1
        e1 = np.zeros(k + 1, dtype=dtype)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(H[: k + 1, :k], e1, rcond=None)
        rnorm = np.linalg.norm(H[: k + 1, :k] @ y - e1)
        if callback is not None:
            callback(None)   # the reference only counts iterations
        if rnorm < tol * bnrm:
            break
    x = Z[:k].T @ y
    return x, 0


_loaded: Dict[str, object] = {}


def load_reference():
    """Import the reference modules (shimmed); returns a namespace dict
    {matrix, multigrid, stoch_trace, utils}. Cached per process."""
    if _loaded:
        return _loaded
    if not reference_available():
        raise RuntimeError(f"reference not available at {REF_DIR}")
    os.environ.setdefault("OMP_NUM_THREADS", "1")

    # pyamg stub (must exist before `from pyamg.krylov import fgmres`)
    if "pyamg" not in sys.modules:
        fake_k = types.ModuleType("pyamg.krylov")
        fake_k.fgmres = pure_fgmres
        fake_p = types.ModuleType("pyamg")
        fake_p.krylov = fake_k
        sys.modules["pyamg"] = fake_p
        sys.modules["pyamg.krylov"] = fake_k
        # multigrid.py:6 imports adaptive_sa_solver but never calls it
        fake_a = types.ModuleType("pyamg.aggregation")
        fake_a.__path__ = []  # mark as package so submodule import resolves
        fake_ad = types.ModuleType("pyamg.aggregation.adaptive")
        fake_ad.adaptive_sa_solver = None
        fake_a.adaptive = fake_ad
        fake_a.adaptive_sa_solver = None
        sys.modules["pyamg.aggregation"] = fake_a
        sys.modules["pyamg.aggregation.adaptive"] = fake_ad
        fake_p.aggregation = fake_a

    # scipy lgmres tol->rtol compat (scipy >= 1.14)
    import inspect

    import scipy.sparse.linalg as sla

    if "tol" not in inspect.signature(sla.lgmres).parameters:
        _orig = sla.lgmres

        def lgmres_compat(A, b, x0=None, tol=1e-5, maxiter=1000, **kw):
            return _orig(A, b, x0=x0, rtol=tol, atol=0.0, maxiter=maxiter, **kw)

        sla.lgmres = lgmres_compat

    if REF_DIR not in sys.path:
        sys.path.insert(0, REF_DIR)
    for name in ("matrix", "multigrid", "utils", "stoch_trace"):
        _loaded[name] = importlib.import_module(name)
    return _loaded


def load_matrix(name: str, mass: float):
    """reference loadMatrix, run from inside REF_DIR (string-keyed gamma3
    fixup + CWD-relative .mat paths)."""
    ref = load_reference()
    cwd = os.getcwd()
    try:
        os.chdir(REF_DIR)
        A = ref["matrix"].loadMatrix(name, {"mass": mass})
    finally:
        os.chdir(cwd)
    return A.tocsr()


def params_16(function_tol=1e-12) -> dict:
    """Repaired schwinger16 trace-params dict (the shipped set crashes --
    SURVEY.md section 2.1 known defects; same repair as our gateway)."""
    return dict(
        tol=1.0e-2,
        function_params=dict(tol=function_tol),
        max_nr_ests=100000,
        max_nr_levels=3,
        problem_name="schwinger",
        nr_deflat_vctrs=24,
        mlmc_deflat_vctrs=[8, 8],
        defl_eigvs_tol_Hutch=1.0e-9,
        defl_eigvs_tol_MLMC=1.0e-1,
        diff_lev_op_tol=1.0e-3,
        defl_type="exact",
        coarsest_level_directly=True,
        accuracy_mg_eigvs="low",
        aggrs=[4, 4],
        dof=[2, 4, 4],
        mlmc_levels_to_skip=[],
        use_permuted=False,
        latt_dims=[16, 16],
        x_displacement=0,
        check_quality_MG=False,
        test_vectors_type="EVs",
    )


def params_128_parity(function_tol=1e-12) -> dict:
    """The reference's shipped schwinger128 trace-params surface
    (reference gateway.py:98-166 via trace_params_from_params)."""
    return dict(
        tol=1.0e-2,
        function_params=dict(tol=function_tol),
        max_nr_ests=100000,
        max_nr_levels=4,
        problem_name="schwinger",
        nr_deflat_vctrs=8,
        mlmc_deflat_vctrs=[0, 0, 0],
        defl_eigvs_tol_Hutch=1.0e-9,
        defl_eigvs_tol_MLMC=1.0e-1,
        diff_lev_op_tol=1.0e-3,
        defl_type="exact",
        coarsest_level_directly=True,
        accuracy_mg_eigvs="high",
        aggrs=[4 * 4, 2 * 2, 2 * 2],
        dof=[2, 8, 8, 8],
        mlmc_levels_to_skip=[1],
        use_permuted=True,
        latt_dims=[128, 128],
        x_displacement=2,
        check_quality_MG=False,
        test_vectors_type="EVs",
    )


def build_mg(A, params):
    """MG construction + setup exactly as the estimators do it
    (reference stoch_trace.py:39-77), returning the configured solver."""
    from scipy.sparse import csr_matrix

    ref = load_reference()
    mg_solver = ref["multigrid"].MG(A)
    mg_solver.coarsest_iters = 0
    mg_solver.coarsest_iters_tot = 0
    mg_solver.coarsest_iters_avg = 0
    mg_solver.nr_calls = 0
    mg_solver.setup(
        dof=params["dof"], aggrs=params["aggrs"],
        max_levels=params["max_nr_levels"], dim=2,
        acc_eigvs=params["accuracy_mg_eigvs"],
        sys_type=params["problem_name"], params=params,
    )
    nr_levels = len(mg_solver.ml.levels)
    mg_solver.total_levels = nr_levels
    for i in range(nr_levels):
        mg_solver.coarsest_lev_iters[i] = 0
    for i in range(nr_levels - 1):
        mg_solver.ml.levels[i].P = csr_matrix(mg_solver.ml.levels[i].P)
        mg_solver.ml.levels[i].R = csr_matrix(mg_solver.ml.levels[i].R)
    return mg_solver


def mlmc_probes(mg_solver, params, level: int, nprobes: int, seed: int):
    """Draw ``nprobes`` matched-seed MLMC difference-level estimates through
    the reference per-probe step (reference utils.py:252-357, the
    stoch_trace.py:386-391 call form), undeflated, no level skipping."""
    ref = load_reference()
    mg_solver.skip_level = False
    Af = mg_solver.ml.levels[level].A
    Ac = mg_solver.ml.levels[level + 1].A
    P = mg_solver.ml.levels[level].P
    R = mg_solver.ml.levels[level].R
    output_params = {
        "results": [dict(function_iters=0) for _ in mg_solver.ml.levels]
    }
    np.random.seed(seed)
    es = np.zeros(nprobes, dtype=complex)
    for j in range(nprobes):
        e, _ = ref["utils"].one_defl_Hutch_step(
            Af, Ac, mg_solver, params, "mlmc", 0, None, None, level,
            output_params, P, R,
        )
        es[j] = e
    return es


def _make_dense_pair_p():
    """DensePairP: adapter exposing a reference CSR prolongator through our
    pair P-interface (apply / apply_adjoint / to_dense) so the reference's
    OWN hierarchy can be imported into our MGSolver for matched-seed parity.
    The reference aggregates scatter over the spin-major fine index, so its
    P is not block-diagonal under our contiguous-aggregate layout -- at
    parity-test sizes a dense pair matmul is exact and fast.

    Declared as a pytree dataclass (lazily, keeping refharness importable
    without jax side effects at module load) because the hierarchy rides
    MGSolver.solve's jitted program as the ``ctx`` ARGUMENT
    (solvers/fgmres.py) -- every node in it must be a registered pytree."""
    from deflatedmlmc_schwinger_tpu.ops import cplx
    from deflatedmlmc_schwinger_tpu.ops.cplx import CP
    from deflatedmlmc_schwinger_tpu.ops.pytree import pytree_dataclass

    @pytree_dataclass
    class DensePairP:
        mat: CP

        @classmethod
        def from_csr(cls, Pcsr, rdtype):
            import jax.numpy as jnp

            M = np.asarray(Pcsr.todense())
            return cls(mat=CP(jnp.asarray(M.real.astype(np.dtype(rdtype))),
                              jnp.asarray(M.imag.astype(np.dtype(rdtype)))))

        def apply(self, y):           # P @ y for (..., n_c) pair rows
            return cplx.einsum2("fc,...c->...f", self.mat, y)

        def apply_adjoint(self, x):   # P^H @ x for (..., n_f) pair rows
            return cplx.einsum2_conj_a("fc,...f->...c", self.mat, x)

        def to_dense(self) -> np.ndarray:
            return (np.asarray(self.mat.re, np.float64)
                    + 1j * np.asarray(self.mat.im, np.float64))

    return DensePairP


_DensePairP = None


def dense_pair_p(Pcsr, rdtype):
    global _DensePairP
    if _DensePairP is None:
        _DensePairP = _make_dense_pair_p()
    return _DensePairP.from_csr(Pcsr, rdtype)


def import_hierarchy(mg_solver, pair_op0, rdtype):
    """Convert the reference MG hierarchy into our Hierarchy so both
    estimators run on IDENTICAL operators/P/R (per-level MLMC difference
    traces are hierarchy-specific -- SURVEY.md section 4 -- so matched-seed
    per-level parity requires importing the hierarchy, not rebuilding one).
    ``pair_op0``: our device operator for the fine level (exact CSR match is
    separately tested in tests/test_stencil.py)."""
    import jax.numpy as jnp

    from deflatedmlmc_schwinger_tpu.mg.hierarchy import (
        DenseOperator,
        Hierarchy,
        MGLevel,
    )
    from deflatedmlmc_schwinger_tpu.ops.cplx import CP

    nl = len(mg_solver.ml.levels)
    levels = []
    for i in range(nl):
        if i == 0:
            op_i = pair_op0
        else:
            M = np.asarray(mg_solver.ml.levels[i].A.todense())
            op_i = DenseOperator(
                mat=CP(jnp.asarray(M.real.astype(np.dtype(rdtype))),
                       jnp.asarray(M.imag.astype(np.dtype(rdtype))))
            )
        P = (dense_pair_p(mg_solver.ml.levels[i].P, rdtype)
             if i < nl - 1 else None)
        levels.append(MGLevel(op=op_i, P=P, perm_shift=0))
    Cinv = np.asarray(mg_solver.coarsest_inv)
    coarsest_inv = CP(jnp.asarray(Cinv.real.astype(np.dtype(rdtype))),
                      jnp.asarray(Cinv.imag.astype(np.dtype(rdtype))))
    return Hierarchy(levels=tuple(levels), coarsest_inv=coarsest_inv)


def hutch_probes(mg_solver, A, params, nprobes: int, seed: int,
                 Vx=None, k: int = 0):
    """Draw ``nprobes`` matched-seed Hutchinson estimates through the
    reference per-probe step (reference utils.py:210-250): seeds the global
    NumPy RNG, then calls one_defl_Hutch_step sequentially. Returns the
    complex (nprobes,) per-probe estimates and total solver iterations."""
    ref = load_reference()
    np.random.seed(seed)
    es = np.zeros(nprobes, dtype=complex)
    iters = 0
    for i in range(nprobes):
        e, it = ref["utils"].one_defl_Hutch_step(
            A, None, mg_solver, params, "hutchinson", k, Vx, None
        )
        es[i] = e
        iters += int(it)
    return es, iters
