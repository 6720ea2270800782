"""Eigsolvers for setup phases: device replacements for ARPACK.

The reference computes
  * near-kernel test vectors per MG level with shift-invert ARPACK
    ``eigs(A, sigma=0)`` / ``eigsh(Q, sigma=0)`` backed by a SuperLU
    factorization (reference: multigrid.py:157-188),
  * the Hutchinson deflation basis with ``eigsh(Q, k, sigma=0)``
    (utils.py:137-140), and
  * MLMC difference-operator deflation with plain Lanczos ``eigsh(lop, k)``
    (utils.py:141-143).

There is no sparse LU on the device; instead:
  * smallest-|lambda| eigenpairs of the Hermitian Q = gamma3 @ A come from
    Chebyshev-filtered subspace iteration (CheFSI) on Q^2 -- a jittable,
    batched three-term recurrence in pair arithmetic;
  * when a solver for A is available (the MG hierarchy itself), inverse
    subspace iteration V <- A^{-1} gamma3 V converges in a handful of rounds
    (the survey's "shift-invert replaced by the MG-preconditioned solver"
    design, SURVEY.md section 2.2 N2/N3);
  * largest-|lambda| eigenpairs of a Hermitian operator (the MLMC difference
    operator) come from block power iteration.

Heavy operator applications run on device in CP pair form; the small dense
Ritz problems (k x k) run on the host in numpy -- setup-phase only, and the
extraction uses HARMONIC Ritz: plain Rayleigh--Ritz on an indefinite operator
produces spurious near-zero "ghost" values from non-invariant directions,
while harmonic values theta = ||Hw||^2 / <w,Hw> cannot sit near zero unless
||Hw|| is genuinely small.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla
from jax import lax

from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP


class EigResult(NamedTuple):
    values: np.ndarray    # (k,) real, sorted ascending by |value|
    vectors: np.ndarray   # (n, k) complex (host)
    resnorms: np.ndarray  # (k,) ||H v - theta v||_2


# ---- host <-> device column-batch helpers ---------------------------------

def _apply_cols(matvec_pair: Callable, W: np.ndarray, rdtype) -> np.ndarray:
    """Apply a pair operator to the columns of a host complex (n, m) matrix."""
    p = CP(jnp.asarray(np.ascontiguousarray(W.real.T), rdtype),
           jnp.asarray(np.ascontiguousarray(W.imag.T), rdtype))
    out = matvec_pair(p)
    return cplx.to_complex(out).T


def _orth(V: np.ndarray) -> np.ndarray:
    Q, R = np.linalg.qr(V)
    d = np.diagonal(R)
    phase = np.where(np.abs(d) > 0, d / np.maximum(np.abs(d), 1e-300), 1.0)
    return Q * np.conj(phase)[None, :]


def power_bound(matvec_pair: Callable, n: int, rdtype, seed: int = 17,
                iters: int = 25, ctx=None) -> float:
    """Upper estimate of the largest |eigenvalue| of a Hermitian pair
    operator. One jitted fori_loop launch instead of one dispatch and one
    host round-trip per iteration.

    ``ctx``: optional operator pytree passed as a jit ARGUMENT; the matvec
    is then called as matvec_pair(ctx, v), keeping operator tensors out of
    the compiled executable (see solvers/fgmres.py ctx)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n).astype(np.dtype(rdtype))

    @jax.jit
    def run(ctx, p: CP):
        def body(_, carry):
            p, _ = carry
            w = matvec_pair(ctx, p) if ctx is not None else matvec_pair(p)
            nw = jnp.sqrt(cplx.norm2(w))
            return (cplx.scale_real(w, 1.0 / jnp.maximum(nw, 1e-30)), nw)

        _, lam = lax.fori_loop(0, iters, body, (p, jnp.zeros((), rdtype)))
        return lam

    lam = float(run(ctx, CP(jnp.asarray(v), jnp.zeros(n, rdtype))))
    return lam * 1.05


def harmonic_ritz_smallest(matvec_pair: Callable, V: np.ndarray, k: int,
                           rdtype) -> EigResult:
    """Harmonic Rayleigh--Ritz targeting eigenvalues nearest 0 (host)."""
    W = _orth(V)
    U = _apply_cols(matvec_pair, W, rdtype)
    A = U.conj().T @ W
    A = 0.5 * (A + A.conj().T)
    Bm = U.conj().T @ U
    Bm = 0.5 * (Bm + Bm.conj().T)
    m = W.shape[1]
    scale = float(np.real(np.trace(Bm))) / m
    L = np.linalg.cholesky(Bm + (1e3 * np.finfo(np.dtype(rdtype)).eps * scale)
                           * np.eye(m))
    M = sla.solve_triangular(L, A, lower=True)
    M = sla.solve_triangular(L, M.conj().T, lower=True).conj().T
    M = 0.5 * (M + M.conj().T)
    mu, Z = np.linalg.eigh(M)
    y = sla.solve_triangular(L.conj().T, Z, lower=False)
    X = W @ y
    X = X / np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-300)
    HX = _apply_cols(matvec_pair, X, rdtype)
    theta = np.real(np.sum(np.conj(X) * HX, axis=0))
    with np.errstate(divide="ignore"):
        order = np.argsort(np.where(np.abs(mu) > 0, 1.0 / np.abs(mu), np.inf))[:k]
    theta = theta[order]
    X = X[:, order]
    R = HX[:, order] - X * theta[None, :]
    return EigResult(values=theta, vectors=X, resnorms=np.linalg.norm(R, axis=0))


def rayleigh_ritz_hermitian(matvec_pair: Callable, V: np.ndarray, k: int,
                            rdtype, which: str = "largest_abs") -> EigResult:
    """Plain Rayleigh--Ritz (extremal eigenvalues -- ghost-free there)."""
    W = _orth(V)
    HW = _apply_cols(matvec_pair, W, rdtype)
    M = W.conj().T @ HW
    M = 0.5 * (M + M.conj().T)
    theta, Y = np.linalg.eigh(M)
    if which == "largest_abs":
        order = np.argsort(-np.abs(theta))[:k]
    elif which == "smallest_abs":
        order = np.argsort(np.abs(theta))[:k]
    else:
        raise ValueError(which)
    theta = theta[order]
    X = W @ Y[:, order]
    R = _apply_cols(matvec_pair, X, rdtype) - X * theta[None, :]
    return EigResult(values=theta, vectors=X, resnorms=np.linalg.norm(R, axis=0))


@functools.lru_cache(maxsize=64)
def _filter_factory(matvec_pair: Callable):
    """Jitted Chebyshev filter in t = lambda^2 mapped to [a, b] (pair ops,
    loop-safe); cached per operator closure. ``ctx`` (optional): operator
    pytree as a jit argument, matvec then called matvec_pair(ctx, X).

    lru_cache: callers that pass a STABLE module-level matvec (ctx style)
    reuse the traced kernels across invocations -- re-tracing the Ritz
    machinery cost seconds of 2-core host time per deflation call
    (measured r5 inside defl_setup)."""

    @functools.partial(jax.jit, static_argnames=("deg",))
    def filter_rounds(Vp: CP, a, b, deg: int, ctx=None):
        c0 = (a + b) / (b - a)
        c1 = 2.0 / (b - a)

        def mv(X: CP) -> CP:
            return matvec_pair(ctx, X) if ctx is not None else matvec_pair(X)

        def y(X: CP) -> CP:
            h2 = mv(mv(X))
            return CP(c1 * h2.re - c0 * X.re, c1 * h2.im - c0 * X.im)

        T0 = Vp
        T1 = y(Vp)

        def body(_, carry):
            Tm1, Tm0 = carry
            Ty = y(Tm0)
            Tp = CP(2.0 * Ty.re - Tm1.re, 2.0 * Ty.im - Tm1.im)
            # Per-column rescale of BOTH carries (the recurrence is linear
            # and column-independent, so this preserves directions) -- the
            # unnormalized T_k grows like e^{deg} outside [a,b] and
            # overflows float32 at the production degrees.
            s = 1.0 / jnp.maximum(jnp.sqrt(cplx.norm2(Tp, axis=-1)), 1e-30)[..., None]
            return (cplx.scale_real(Tm0, s), cplx.scale_real(Tp, s))

        _, Tk = lax.fori_loop(0, deg - 1, body, (T0, T1))
        nrm = jnp.sqrt(cplx.norm2(Tk, axis=-1))[..., None]
        return cplx.scale_real(Tk, 1.0 / jnp.maximum(nrm, 1e-30))

    return filter_rounds


@functools.lru_cache(maxsize=64)
def _ritz_kernels_factory(matvec_pair: Callable):
    """Device kernels for harmonic Ritz with vectors RESIDENT on device as
    (m, n) row pairs. Only m x m matrices ever go to the host, instead of
    the (n, m) per-round transfers of a host-side Ritz."""

    @jax.jit
    def gram(V: CP) -> CP:
        # G[i, j] = <v_i, v_j> for row-vectors
        return cplx.einsum2_conj_a("in,jn->ij", V, V)

    @jax.jit
    def project(V: CP, T: CP, ctx=None):
        # column-space basis change W_cols = V_cols @ T, rows: W = T^T V
        W = cplx.einsum2("ji,jn->in", T, V)
        U = matvec_pair(ctx, W) if ctx is not None else matvec_pair(W)
        A = cplx.einsum2_conj_a("in,jn->ij", U, W)   # U^H W
        B = cplx.einsum2_conj_a("in,jn->ij", U, U)   # U^H U
        return W, U, A, B

    @jax.jit
    def recombine(W: CP, U: CP, Y: CP):
        # X_cols = W_cols @ Y; H X_cols = U_cols @ Y (reuses U -- no matvec)
        X = cplx.einsum2("ji,jn->in", Y, W)
        HX = cplx.einsum2("ji,jn->in", Y, U)
        inv_nrm = 1.0 / jnp.maximum(jnp.sqrt(cplx.norm2(X, axis=-1)), 1e-30)
        X = cplx.scale_real(X, inv_nrm[:, None])
        HX = cplx.scale_real(HX, inv_nrm[:, None])
        theta = cplx.cdot(X, HX).re                  # Rayleigh quotients
        R = HX - CP(theta[:, None] * X.re, theta[:, None] * X.im)
        res = jnp.sqrt(cplx.norm2(R, axis=-1))
        return X, HX, theta, res

    return gram, project, recombine


def _harmonic_small_solve(A: np.ndarray, B: np.ndarray, eps: float):
    """Host m x m harmonic-Ritz solve: eigenpairs of the pencil
    (A = U^H W, B = U^H U) ordered by |mu| ascending (theta ~ 1/mu nearest 0).
    Returns the (m, m) recombination matrix Y, ordered."""
    m = A.shape[0]
    A = 0.5 * (A + A.conj().T)
    B = 0.5 * (B + B.conj().T)
    scale = float(np.real(np.trace(B))) / m
    L = np.linalg.cholesky(B + (eps * scale) * np.eye(m))
    M = sla.solve_triangular(L, A, lower=True)
    M = sla.solve_triangular(L, M.conj().T, lower=True).conj().T
    M = 0.5 * (M + M.conj().T)
    mu, Z = np.linalg.eigh(M)
    Y = sla.solve_triangular(L.conj().T, Z, lower=False)
    with np.errstate(divide="ignore"):
        order = np.argsort(np.where(np.abs(mu) > 0, 1.0 / np.abs(mu), np.inf))
    return Y[:, order]


def _to_pair_rows(M: np.ndarray, rdtype) -> CP:
    return CP(jnp.asarray(np.ascontiguousarray(M.real).astype(np.dtype(rdtype))),
              jnp.asarray(np.ascontiguousarray(M.imag).astype(np.dtype(rdtype))))


def chebyshev_filtered_smallest(
    matvec_pair: Callable,
    n: int,
    k: int,
    *,
    rdtype,
    seed: int = 3,
    degree: int = 100,
    rounds: int = 8,
    buffer: Optional[int] = None,
    lam_max: Optional[float] = None,
    cut_init_frac: float = 1.0e-2,
    tol: float = 0.0,
    V0: Optional[np.ndarray] = None,
    ctx=None,
) -> EigResult:
    """Smallest-|lambda| eigenpairs of a Hermitian pair operator via CheFSI
    on H^2 + harmonic Ritz.

    The subspace stays device-resident across rounds; each round is three
    fused launches (filter, projection Grams, recombination) with only m x m
    matrices on the host link. ``V0`` (host (n, m0) complex) warm-starts the
    subspace -- MG setup seeds level l+1 with the restricted level-l test
    vectors, which cuts the rounds needed on coarse levels.

    ``ctx``: optional operator pytree; the matvec is then called as
    matvec_pair(ctx, v) and the operator tensors enter the compiled filter
    and projection programs as ARGUMENTS, not baked constants -- the
    executables stay small (the constant-laden 512^2 filter program
    serialized to ~48 MB and cost ~10 s of load per process launch)."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.5 * k)))
    m = min(m, n)
    if lam_max is None:
        lam_max = power_bound(matvec_pair, n, rdtype, seed=seed + 17, ctx=ctx)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    if V0 is not None:
        m0 = min(V0.shape[1], m)
        V[:, :m0] = V0[:, :m0]
    V = _orth(V)

    filt = _filter_factory(matvec_pair)
    gram, project, recombine = _ritz_kernels_factory(matvec_pair)
    eps = 1e3 * np.finfo(np.dtype(rdtype)).eps
    b = lam_max * lam_max
    cut = lam_max * cut_init_frac
    Vd = _to_pair_rows(V.T, rdtype)                  # device (m, n) rows
    theta = res = None
    for r in range(rounds):
        a = max(cut * cut, b * 1.0e-12)
        Vd = filt(Vd, jnp.asarray(a, rdtype), jnp.asarray(b, rdtype),
                  int(degree), ctx)
        G = cplx.to_complex(gram(Vd))                # m x m down
        Gs = 0.5 * (G + G.conj().T)
        scale = float(np.real(np.trace(Gs))) / m
        L = np.linalg.cholesky(Gs + (eps * scale) * np.eye(m))
        T = sla.solve_triangular(L.conj().T, np.eye(m), lower=False)  # L^{-H}
        W, U, Ad, Bd = project(Vd, _to_pair_rows(T, rdtype), ctx)
        Y = _harmonic_small_solve(cplx.to_complex(Ad), cplx.to_complex(Bd), eps)
        Vd, HXd, theta_d, res_d = recombine(W, U, _to_pair_rows(Y, rdtype))
        theta = np.asarray(theta_d, dtype=np.float64)
        res = np.asarray(res_d, dtype=np.float64)
        theta_abs = np.sort(np.abs(theta))
        new_cut = float(theta_abs[min(k, m - 1)])
        if new_cut > 0:
            cut = min(max(new_cut, 1e-8 * lam_max), 0.5 * lam_max)
        if tol > 0 and float(np.max(res[:k])) < tol:
            break
    X = cplx.to_complex(Vd).T
    return EigResult(theta[:k], X[:, :k], res[:k])


def inverse_iteration_smallest(
    matvec_pair: Callable,
    apply_inv_pair: Callable,
    n: int,
    k: int,
    *,
    rdtype,
    seed: int = 5,
    rounds: int = 6,
    buffer: Optional[int] = None,
    tol: float = 0.0,
    V0: Optional[np.ndarray] = None,
) -> EigResult:
    """Smallest-|lambda| eigenpairs via inverse subspace iteration
    V <- H^{-1} V (``apply_inv_pair`` applies H^{-1} to (B, n) pair batches;
    typically the MG-preconditioned solve composed with gamma3)."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.25 * k)))
    m = min(m, n)
    if V0 is not None:
        V = V0
        m = V.shape[1]
    else:
        rng = np.random.default_rng(seed)
        V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    result = None
    for r in range(rounds):
        V = _orth(V)
        V = _apply_cols(apply_inv_pair, V, rdtype)
        result = harmonic_ritz_smallest(matvec_pair, V, m, rdtype)
        V = result.vectors
        if tol > 0 and float(np.max(result.resnorms[:k])) < tol:
            break
    return EigResult(result.values[:k], result.vectors[:, :k], result.resnorms[:k])


@functools.lru_cache(maxsize=64)
def _device_round_factory(matvec_pair: Callable):
    """One whole harmonic-Ritz round as a single jitted program
    (gram -> whitening chol -> projection -> harmonic pencil solve ->
    recombination): the m x m cholesky/eigh/triangular solves run on
    complex inputs, the big contractions stay pair-form einsums. Replaces
    ~6 small host round-trips per round; the only per-round fetch is the
    stacked (theta, res) diagnostics pair. Factory-cached per matvec so
    repeated deflation calls (MLMC + rough + Hutchinson in one process)
    reuse the traced program instead of re-tracing it."""
    gram, project, recombine = _ritz_kernels_factory(matvec_pair)
    from jax.scipy.linalg import solve_triangular as jsolve_tri

    @jax.jit
    def device_round(Vd: CP, ctx=None):
        m = Vd.re.shape[0]
        rdtype = Vd.re.dtype
        eps = 1e3 * jnp.finfo(rdtype).eps
        eyec = jnp.eye(m, dtype=cplx.complex_dtype(rdtype))
        G = gram(Vd)
        Gc = G.re + 1j * G.im
        Gs = 0.5 * (Gc + Gc.conj().T)
        scale = jnp.real(jnp.trace(Gs)) / m
        L = jnp.linalg.cholesky(Gs + (eps * scale) * eyec)
        T = jsolve_tri(L.conj().T, eyec, lower=False)
        W, U, Ad, Bd = project(Vd, CP(jnp.real(T), jnp.imag(T)), ctx)
        A = Ad.re + 1j * Ad.im
        B = Bd.re + 1j * Bd.im
        A = 0.5 * (A + A.conj().T)
        B = 0.5 * (B + B.conj().T)
        scb = jnp.real(jnp.trace(B)) / m
        Lb = jnp.linalg.cholesky(B + (eps * scb) * eyec)
        M = jsolve_tri(Lb, A, lower=True)
        M = jsolve_tri(Lb, M.conj().T, lower=True).conj().T
        M = 0.5 * (M + M.conj().T)
        mu, Z = jnp.linalg.eigh(M)
        Y = jsolve_tri(Lb.conj().T, Z, lower=False)
        order = jnp.argsort(
            jnp.where(jnp.abs(mu) > 0, 1.0 / jnp.abs(mu), jnp.inf)
        )
        Y = Y[:, order]
        Vd2, _, theta, res = recombine(W, U, CP(jnp.real(Y), jnp.imag(Y)))
        return Vd2, jnp.stack([theta, res])

    return device_round


class DeviceEigResult(NamedTuple):
    values: np.ndarray    # (k,) real (host)
    vectors: CP           # (k, n) ROW pairs, device-resident
    resnorms: np.ndarray  # (k,) (host)


def inverse_iteration_smallest_device(
    matvec_pair: Callable,
    apply_inv_pair: Callable,
    n: int,
    k: int,
    *,
    rdtype,
    seed: int = 5,
    rounds: int = 6,
    buffer: Optional[int] = None,
    tol: float = 0.0,
    V0: Optional[np.ndarray] = None,
    warm_filter_degree: int = 0,
    ctx=None,
) -> DeviceEigResult:
    """Device-resident twin of ``inverse_iteration_smallest``: the subspace
    stays on the device as (m, n) row pairs across rounds; per round only the
    m x m Gram/projection matrices and the (m,) Ritz residuals go to the
    host. The host version round-trips the full (n, m) basis ~6 times per
    round.

    ``warm_filter_degree`` > 0 runs ONE Chebyshev filter pass (in t =
    lambda^2, solvers/eigs.py _filter_factory) of that degree over the
    random start block before the first solve round. A filter matvec is far
    cheaper than one inverse round of MG solves on near-kernel right-hand
    sides, and a degree-d filter boosts modes under the cut by
    ~e^{2 d sqrt(a/b)} over the bulk (config.py defl_warm_filter_degree)."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.25 * k)))
    m = min(m, n)
    if V0 is not None:
        m = V0.shape[1]
        Vd = _to_pair_rows(_orth(V0).T, rdtype)      # device (m, n) rows
    else:
        # Generate the start block ON DEVICE and skip the host QR: a host
        # Gaussian + QR of the (n, m) block costs seconds at the flagship
        # size plus an upload, while the round's own whitening transform
        # orth_T handles the conditioning -- i.i.d.
        # Gaussian rows have Gram ~ n*(I + O(sqrt(m/n))), far from singular.
        kre, kim = jax.random.split(jax.random.PRNGKey(seed))
        Vd = CP(
            jax.random.normal(kre, (m, n), dtype=jnp.dtype(rdtype)),
            jax.random.normal(kim, (m, n), dtype=jnp.dtype(rdtype)),
        )
    if warm_filter_degree and V0 is None:
        lam = power_bound(matvec_pair, n, rdtype, seed=seed + 17, ctx=ctx)
        b = lam * lam
        # cut at ~1% of lam_max: the near-critical modes this deflation
        # exists for sit 2+ orders below the bulk edge, and the filter only
        # needs to hand inverse iteration a subspace dominated by them
        a = max((1.0e-2 * lam) ** 2, b * 1.0e-12)
        filt = _filter_factory(matvec_pair)
        Vd = filt(Vd, jnp.asarray(a, rdtype), jnp.asarray(b, rdtype),
                  int(warm_filter_degree), ctx)
    gram, project, recombine = _ritz_kernels_factory(matvec_pair)
    eps = 1e3 * np.finfo(np.dtype(rdtype)).eps
    def orth_T(Vd: CP) -> np.ndarray:
        """Host m x m whitening transform T = chol(V V^H)^{-H}: rows of
        T^T V are orthonormal (to working precision)."""
        G = cplx.to_complex(gram(Vd))                # m x m down
        Gs = 0.5 * (G + G.conj().T)
        scale = float(np.real(np.trace(Gs))) / m
        L = np.linalg.cholesky(Gs + (eps * scale) * np.eye(m))
        return sla.solve_triangular(L.conj().T, np.eye(m), lower=False)

    device_round = _device_round_factory(matvec_pair)
    prev_theta = None
    for r in range(rounds):
        Vd = apply_inv_pair(Vd)                      # (m, n) batched solve
        Vd, diag_d = device_round(Vd, ctx)
        diag = np.asarray(diag_d, dtype=np.float64)  # ONE fetch per round
        theta_full, res = diag[0], diag[1]
        theta_r = np.abs(theta_full)[:k]
        if tol > 0 and float(np.max(res[:k])) < tol:
            # Residuals measure Ritz-pair quality, NOT subspace
            # completeness: a deficient subspace (an interior mode not yet
            # pulled in) can show k small residuals and exit with a wrong
            # basis. Require the k smallest |theta| to be stable across two
            # consecutive rounds as well -- a still-arriving mode shifts the
            # ordering between rounds, a converged one does not.
            if prev_theta is not None and float(np.max(
                np.abs(np.sort(theta_r) - np.sort(prev_theta))
                / np.maximum(np.sort(prev_theta), 1e-300)
            )) < np.sqrt(max(tol, 1e-12)):
                break
        prev_theta = theta_r
    # Final extraction by PLAIN Rayleigh--Ritz on an orthonormalized basis:
    # harmonic recombination (Y = L^{-H} Z) is not unitary, so the rows above
    # are individually normalized but NOT mutually orthogonal -- a projector
    # built from them under-deflates (measured ||U^H U - I|| ~ 0.7 in f32).
    # Here Z is unitary, so X = Z^T W is orthonormal to working precision.
    W, U, Ad, _ = project(Vd, _to_pair_rows(orth_T(Vd), rdtype), ctx)
    M = cplx.to_complex(Ad)                          # U^H W = W^H Q W
    M = 0.5 * (M + M.conj().T)
    mu, Z = np.linalg.eigh(M)
    order = np.argsort(np.abs(mu))
    Vd, _, theta_d, res_d = recombine(W, U, _to_pair_rows(Z[:, order], rdtype))
    theta = np.asarray(theta_d, dtype=np.float64)
    res = np.asarray(res_d, dtype=np.float64)
    # GHOST REJECTION: plain RR on the indefinite Q can mix leftover +bulk
    # and -bulk buffer content into a spurious pair with a near-zero
    # Rayleigh quotient. Ghosts betray themselves by their residual: a
    # genuine inverse-iterated pair has ||Q x - theta x|| << |theta| while a
    # ghost's residual is O(bulk) >> |theta| (measured at 16^2: ghost
    # res/|theta| = 7.2 vs <= 0.1 for every true pair). Select the k
    # smallest-|theta| pairs that pass res <= 0.5 |theta|; if fewer than k
    # pass (very loose bases), pad with the best remaining pairs so shapes
    # stay static -- an imperfect vector costs variance only (the 'solve'
    # correction keeps tr1 exact for ANY basis, trace/deflation.py).
    ok = res <= 0.5 * np.abs(theta)
    sel = [i for i in range(len(theta)) if ok[i]][:k]
    if len(sel) < k:
        sel += [i for i in range(len(theta)) if not ok[i]][: k - len(sel)]
        sel = sorted(sel)
    idx = np.asarray(sel, dtype=np.int64)
    Vk = CP(Vd.re[idx], Vd.im[idx])
    return DeviceEigResult(theta[idx], Vk, res[idx])


def subspace_iteration_largest(
    matvec_pair: Callable,
    n: int,
    k: int,
    *,
    rdtype,
    seed: int = 11,
    rounds: int = 10,
    buffer: Optional[int] = None,
    tol: float = 0.0,
) -> EigResult:
    """Largest-|lambda| eigenpairs by block power iteration + Rayleigh--Ritz
    (the MLMC difference-operator deflation, reference: utils.py:141-143,
    needs only loose accuracy -- tol 1e-1)."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.25 * k)))
    m = min(m, n)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    result = None
    for r in range(rounds):
        V = _orth(V)
        V = _apply_cols(matvec_pair, V, rdtype)
        result = rayleigh_ritz_hermitian(matvec_pair, V, m, rdtype, "largest_abs")
        V = result.vectors
        if tol > 0 and float(np.max(result.resnorms[:k])) < tol:
            break
    return EigResult(result.values[:k], result.vectors[:, :k], result.resnorms[:k])


def smallest_eigpairs_nonhermitian(
    matvec_A_pair: Callable,
    matvec_Q_pair: Callable,
    n: int,
    k: int,
    *,
    rdtype,
    seed: int = 23,
    degree: int = 100,
    rounds: int = 8,
    buffer: Optional[int] = None,
    V0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate smallest-|lambda| eigenpairs of the NON-Hermitian A
    ('EVs' test-vector mode, reference: multigrid.py:173-174): CheFSI
    subspace on Q^2 = A^H A, oblique Ritz G = W^H A W on the host. Hierarchy
    quality (variance), never estimator bias, depends on this choice."""
    m = buffer if buffer is not None else max(k + 2, 2 * k)
    sub = chebyshev_filtered_smallest(
        matvec_Q_pair, n, m, rdtype=rdtype, seed=seed, degree=degree,
        rounds=rounds, buffer=max(m + 2, int(round(1.25 * m))), V0=V0,
    )
    W = _orth(sub.vectors)
    AW = _apply_cols(matvec_A_pair, W, rdtype)
    G = W.conj().T @ AW
    theta, Y = np.linalg.eig(G)
    order = np.argsort(np.abs(theta))[:k]
    return theta[order], W @ Y[:, order]
