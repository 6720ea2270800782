"""Host-side (numpy/scipy) MG hierarchy setup -- the default fast path.

Why this exists: the hierarchy setup is a ONE-TIME computation of a few
GFLOPs (CheFSI test vectors, batched QR, Galerkin products, one small dense
inverse), while the device path (mg/setup.py) compiles ~20 distinct XLA
programs for it. This module runs the same algorithms in numpy/scipy on the
host, and only the finished hierarchy tensors go to the device once. Which
backend is faster on the GPU is not measured. The hot path -- every solve --
stays on the device.

Same algorithmic contract as mg/setup.py (reference: multigrid.py:100-344):
CheFSI + harmonic Ritz near-kernel test vectors (in place of shift-invert
ARPACK), spin-split per-aggregate-QR block prolongators, Galerkin coarse
operators with cyclic-block-stencil detection, dense coarsest inverse,
per-level displacement shifts.  The device path (mg/setup.py) remains for
setup_backend='device' (lattices whose fine matvec is too big for host).

All host math in complex128; tensors are cast to the operator dtype on
upload, matching the device path's precision at every consumer.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.io.stencil import csr_from_stencil
from deflatedmlmc_schwinger_tpu.mg.hierarchy import (
    BlockProlongator,
    BlockStencilOperator,
    DenseOperator,
    Hierarchy,
    MGLevel,
    pack_grouped,
)
from deflatedmlmc_schwinger_tpu.mg.setup import p_blocks_host
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.dirac import (
    PairStencilOperator,
    StencilOperator,
    pair_operator,
)
from deflatedmlmc_schwinger_tpu.solvers.eigs import (
    _harmonic_small_solve,
    _orth,
)


def _gamma3_rows(W: np.ndarray) -> np.ndarray:
    """gamma3 @ W: negate the lower spin half of the rows (every level --
    aggregates never straddle the half boundary, see mg/setup.check_quality)."""
    half = W.shape[0] // 2
    out = W.copy()
    out[half:] = -out[half:]
    return out


def _power_bound_host(qmul: Callable, n: int, seed: int, iters: int = 25) -> float:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 1))
    lam = 0.0
    for _ in range(iters):
        w = qmul(v)
        lam = float(np.linalg.norm(w))
        v = w / max(lam, 1e-300)
    return lam * 1.05


def chefsi_host(
    qmul: Callable,
    n: int,
    k: int,
    *,
    seed: int,
    degree: int,
    rounds: int,
    tol: float = 0.0,
    V0: Optional[np.ndarray] = None,
    lam_max: Optional[float] = None,
    buffer: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Smallest-|lambda| eigenpairs of a Hermitian operator (column matvec
    ``qmul``: (n, m) -> (n, m)) via Chebyshev-filtered subspace iteration on
    H^2 + harmonic Ritz -- the host twin of solvers/eigs.py
    chebyshev_filtered_smallest (same recurrence, same extraction).
    Returns (values[k], vectors (n, k), resnorms[k])."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.5 * k)))
    m = min(m, n)
    if lam_max is None:
        lam_max = _power_bound_host(qmul, n, seed + 17)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    if V0 is not None:
        m0 = min(V0.shape[1], m)
        V[:, :m0] = V0[:, :m0]
    V = _orth(V)
    eps = 1e3 * np.finfo(np.float64).eps
    b = lam_max * lam_max
    cut = lam_max * 1.0e-2
    theta = res = None
    for _ in range(rounds):
        a = max(cut * cut, b * 1.0e-12)
        c0 = (a + b) / (b - a)
        c1 = 2.0 / (b - a)

        def y(X):
            return c1 * qmul(qmul(X)) - c0 * X

        T0, T1 = V, y(V)
        for _ in range(degree - 1):
            Tp = 2.0 * y(T1) - T0
            s = 1.0 / np.maximum(np.linalg.norm(Tp, axis=0, keepdims=True), 1e-300)
            T0, T1 = T1 * s, Tp * s
        V = T1 / np.maximum(np.linalg.norm(T1, axis=0, keepdims=True), 1e-300)
        # harmonic Ritz (eigs.py:_harmonic_small_solve ordering contract)
        W = _orth(V)
        U = qmul(W)
        Y = _harmonic_small_solve(U.conj().T @ W, U.conj().T @ U, eps)
        X = W @ Y
        HX = U @ Y
        nrm = np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-300)
        X, HX = X / nrm, HX / nrm
        theta = np.real(np.sum(np.conj(X) * HX, axis=0))
        res = np.linalg.norm(HX - X * theta[None, :], axis=0)
        V = X
        theta_abs = np.sort(np.abs(theta))
        new_cut = float(theta_abs[min(k, m - 1)])
        if new_cut > 0:
            cut = min(max(new_cut, 1e-8 * lam_max), 0.5 * lam_max)
        if tol > 0 and float(np.max(res[:k])) < tol:
            break
    return theta[:k], V[:, :k], res[:k]


def _test_vectors_host(
    A: sp.csr_matrix,
    k: int,
    cfg: TraceConfig,
    seed: int,
    tol: float,
    rounds: int,
    V0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Near-kernel test vectors (reference modes 'EVs' | 'LSVs' | 'RSVs',
    multigrid.py:159-188) from the host CSR level operator."""
    mode = cfg.test_vectors_type
    n = A.shape[0]
    qmul = lambda W: _gamma3_rows(A @ W)
    if mode in ("RSVs", "LSVs"):
        _, V, _ = chefsi_host(
            qmul, n, k, seed=seed, degree=cfg.chebyshev_degree,
            rounds=rounds, tol=tol, V0=V0,
        )
        if mode == "LSVs":
            V = _gamma3_rows(V)
        return V
    elif mode == "EVs":
        # CheFSI subspace on Q^2 = A^H A + oblique Ritz on A (the host twin
        # of eigs.smallest_eigpairs_nonhermitian)
        m = max(k + 2, 2 * k)
        _, Vs, _ = chefsi_host(
            qmul, n, m, seed=seed, degree=cfg.chebyshev_degree,
            rounds=rounds, V0=V0, buffer=max(m + 2, int(round(1.25 * m))),
        )
        W = _orth(Vs)
        G = W.conj().T @ (A @ W)
        theta, Y = np.linalg.eig(G)
        order = np.argsort(np.abs(theta))[:k]
        return W @ Y[:, order]
    raise ValueError(f"unknown test_vectors_type {mode!r}")


def _test_vectors_device(pair0, k: int, cfg: TraceConfig, seed: int,
                         tol: float, rounds: int) -> np.ndarray:
    """Fine-level test vectors via the DEVICE-resident CheFSI
    (solvers/eigs.py): same algorithm as chefsi_host, but the (n, m)
    subspace and the Chebyshev recurrence live on the accelerator -- only
    m x m projections cross the link per round plus one final (n, k)
    download. Used for large lattices where the single-threaded numpy
    recurrence dominates setup (config.py setup_fine_eigs)."""
    from deflatedmlmc_schwinger_tpu.ops.dirac import gamma3_matvec_ctx
    from deflatedmlmc_schwinger_tpu.solvers.eigs import (
        chebyshev_filtered_smallest,
    )

    mode = cfg.test_vectors_type
    if mode not in ("RSVs", "LSVs"):
        raise ValueError(f"device fine eigensolve supports RSVs/LSVs, got {mode!r}")
    # ctx form: the operator rides as a jit argument, so the filter /
    # projection executables carry no baked stencil constants (fast loads,
    # reusable across gauge configurations of the same lattice shape)
    eig = chebyshev_filtered_smallest(
        gamma3_matvec_ctx, pair0.n, k, rdtype=pair0.dtype, seed=seed,
        degree=cfg.chebyshev_degree, rounds=rounds, tol=tol, ctx=pair0,
    )
    V = np.asarray(eig.vectors, dtype=np.complex128)
    if mode == "LSVs":
        V = _gamma3_rows(V)
    return V


def _bsr_from_blocks(blocks: np.ndarray) -> sp.bsr_matrix:
    """Block-diagonal prolongator CSR from (na, L, dc) aggregate blocks."""
    na, L, dc = blocks.shape
    return sp.bsr_matrix(
        (blocks, np.arange(na), np.arange(na + 1)), shape=(na * L, na * dc)
    ).tocsr()


def _block_stencil_host(
    C: sp.csr_matrix, dc: int, rdtype, max_offsets: int = 48
) -> Optional[BlockStencilOperator]:
    """Detect the cyclic block-offset coupling of the Galerkin coarse matrix
    and pack it as a BlockStencilOperator (one COO pass; the host twin of
    mg/setup.galerkin_block_stencil's device detection)."""
    n = C.shape[0]
    if n % dc:
        return None
    nac = n // dc
    coo = C.tocoo()
    mags = np.abs(coo.data)
    scale = float(mags.max()) if mags.size else 0.0
    keep = mags > 1e-12 * max(scale, 1e-30)
    row, col, dat = coo.row[keep], coo.col[keep], coo.data[keep]
    j1, j2 = row // dc, col // dc
    offs = (j2 - j1) % nac
    offsets = np.unique(offs)
    if len(offsets) > max_offsets:
        return None
    kidx = np.searchsorted(offsets, offs)
    blocks = np.zeros((nac, len(offsets), dc, dc), dtype=np.complex128)
    blocks[j1, kidx, row % dc, col % dc] = dat
    return pack_grouped(BlockStencilOperator(
        blocks=CP(
            jnp.asarray(blocks.real.astype(np.dtype(rdtype))),
            jnp.asarray(blocks.imag.astype(np.dtype(rdtype))),
        ),
        offsets=tuple(int(o) for o in offsets),
    ), host_blocks=blocks)


def _poly_roots_host(A: sp.csr_matrix, m: int, seed: int = 29) -> Tuple[complex, ...]:
    """Roots of the m-step GMRES residual polynomial (harmonic Ritz values of
    a short Arnoldi run), Leja-ordered -- host twin of mg/cycle.py
    gmres_poly_roots, computed here so MGSolver needs zero device matvecs."""
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    V = np.zeros((n, m + 1), dtype=complex)
    H = np.zeros((m + 1, m), dtype=complex)
    V[:, 0] = v / np.linalg.norm(v)
    for j in range(m):
        w = A @ V[:, j]
        for i in range(j + 1):
            H[i, j] = np.vdot(V[:, i], w)
            w = w - H[i, j] * V[:, i]
        H[j + 1, j] = np.linalg.norm(w)
        V[:, j + 1] = w / max(H[j + 1, j].real, 1e-300)
    Hm = H[:m, :m]
    f = np.linalg.solve(Hm.conj().T, np.eye(m)[:, -1])
    theta = np.linalg.eigvals(Hm + (abs(H[m, m - 1]) ** 2) * np.outer(f, np.eye(m)[-1]))
    order = [int(np.argmax(np.abs(theta)))]
    for _ in range(m - 1):
        rest = [i for i in range(m) if i not in order]
        prod = [np.prod([abs(theta[i] - theta[o]) for o in order]) for i in rest]
        order.append(rest[int(np.argmax(prod))])
    return tuple(complex(t) for t in theta[order])


def setup_hierarchy_host(op0, cfg: TraceConfig) -> Hierarchy:
    """Build the multigrid hierarchy entirely on the host; upload tensors once.

    Accepts a StencilOperator or PairStencilOperator; level 0 of the returned
    hierarchy is the device PairStencilOperator either way."""
    if isinstance(op0, StencilOperator):
        coeffs = np.asarray(op0.coeffs, dtype=np.complex128)
        nx, nt = op0.nx, op0.nt
        pair0 = pair_operator(op0)
    elif isinstance(op0, PairStencilOperator):
        coeffs = (np.asarray(op0.coeffs.re, dtype=np.float64)
                  + 1j * np.asarray(op0.coeffs.im, dtype=np.float64))
        nx, nt = op0.nx, op0.nt
        pair0 = op0
    else:
        raise TypeError(f"unsupported fine operator {type(op0)!r}")
    rdtype = pair0.dtype

    dof = list(cfg.dof)
    aggrs = list(cfg.aggrs)
    max_levels = int(cfg.max_nr_levels)
    if dof[0] != 2:
        raise ValueError("dof[0] must be 2 (spin components)")
    if cfg.accuracy_mg_eigvs not in ("low", "high"):
        raise ValueError(
            f"accuracy_mg_eigvs must be 'low' or 'high', got {cfg.accuracy_mg_eigvs!r}"
        )
    eig_tol = 1.0e-3 if cfg.accuracy_mg_eigvs == "low" else 1.0e-9
    rounds_coarse = (cfg.subspace_iters_coarse
                     if cfg.subspace_iters_coarse is not None
                     else max(2, cfg.subspace_iters // 2))

    A = csr_from_stencil(coeffs)
    levels: List[MGLevel] = []
    roots: List[Tuple[complex, ...]] = []
    roots_extra: List[Tuple[complex, ...]] = []
    # second smoother depth for the deflation-setup solver (see
    # Hierarchy.poly_roots_extra)
    extra_depth = (cfg.defl_solver.smooth_iters
                   if (cfg.defl_solver is not None
                       and cfg.defl_solver.smooth_iters
                       != cfg.solver.smooth_iters)
                   else None)
    perm_shift = 2 * cfg.nt * cfg.x_displacement if cfg.use_permuted else 0
    tv_warm: Optional[np.ndarray] = None
    dev_op = pair0
    coarsest_dense = None

    fine_dev = cfg.setup_fine_eigs == "device" or (
        cfg.setup_fine_eigs == "auto"
        and pair0.n >= 2 ** 17
        and cfg.test_vectors_type in ("RSVs", "LSVs")
    )
    if cfg.setup_fine_eigs not in ("auto", "host", "device"):
        raise ValueError(
            f"setup_fine_eigs must be 'auto'|'host'|'device', got "
            f"{cfg.setup_fine_eigs!r}"
        )

    for i in range(max_levels - 1):
        L = aggrs[i] * dof[i]
        phase_period = dof[i] if i == 0 else dof[i] // 2
        k = dof[i + 1] // 2
        if i == 0 and fine_dev:
            tv = _test_vectors_device(
                pair0, k, cfg, cfg.seed + 977 * i, eig_tol,
                rounds=cfg.subspace_iters,
            )
        else:
            tv = _test_vectors_host(
                A, k, cfg, cfg.seed + 977 * i, eig_tol,
                rounds=cfg.subspace_iters if tv_warm is None else rounds_coarse,
                V0=tv_warm,
            )
        blocks = p_blocks_host(tv, L, phase_period)
        P = BlockProlongator(
            blocks=CP(
                jnp.asarray(blocks.real.astype(np.dtype(rdtype))),
                jnp.asarray(blocks.imag.astype(np.dtype(rdtype))),
            )
        )
        roots.append(_poly_roots_host(A, cfg.solver.smooth_iters))
        if extra_depth is not None:
            roots_extra.append(_poly_roots_host(A, extra_depth))
        levels.append(MGLevel(op=dev_op, P=P, perm_shift=perm_shift))
        Pcsr = _bsr_from_blocks(blocks)
        tv_warm = np.asarray((Pcsr.conj().T @ tv))
        perm_shift = (perm_shift // L) * dof[i + 1] if cfg.use_permuted else 0
        A = (Pcsr.conj().T.tocsr() @ (A @ Pcsr)).tocsr()
        is_coarsest = i + 1 == max_levels - 1
        dev_op = None
        if not is_coarsest and cfg.coarse_format == "auto":
            dev_op = _block_stencil_host(A, dof[i + 1] * 2, rdtype)
        if dev_op is None:
            coarsest_dense = A.toarray()
            dev_op = DenseOperator(
                mat=CP(
                    jnp.asarray(coarsest_dense.real.astype(np.dtype(rdtype))),
                    jnp.asarray(coarsest_dense.imag.astype(np.dtype(rdtype))),
                )
            )

    if coarsest_dense is None or coarsest_dense.shape[0] != A.shape[0]:
        coarsest_dense = A.toarray()
    levels.append(MGLevel(op=dev_op, P=None, perm_shift=perm_shift))
    Cinv = np.linalg.inv(coarsest_dense)
    coarsest_inv = CP(
        jnp.asarray(Cinv.real.astype(np.dtype(rdtype))),
        jnp.asarray(Cinv.imag.astype(np.dtype(rdtype))),
    )
    return Hierarchy(
        levels=tuple(levels),
        coarsest_inv=coarsest_inv,
        poly_roots=tuple(roots),
        poly_roots_extra=tuple(roots_extra) if roots_extra else None,
    )
