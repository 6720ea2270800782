"""Aggregation-based algebraic multigrid setup on the device.

Reference behavior being reproduced (multigrid.py:100-344):
  * per level, k = dof[i+1]/2 near-kernel test vectors from an eigensolver
    (shift-invert ARPACK there; CheFSI / inverse iteration here -- see
    solvers/eigs.py);
  * the prolongator P assigns each aggregate (a contiguous strip of
    L = aggrs[i]*dof[i] flat indices; strips never straddle the spin
    boundary) two column groups split by the position phase
    (pos % p < p/2 with p = dof[0] at level 0, dof[i]/2 above), each group
    carrying the per-aggregate orthonormalized test vectors
    (multigrid.py:192-259 -- the Python quad loops + CGS become one batched
    host QR);
  * R = P^H (multigrid.py:267-274), Galerkin A_{i+1} = R A_i P
    (multigrid.py:276), dense coarsest inverse (multigrid.py:341-344);
  * per-level displacement shifts for the permuted observable
    (multigrid.py:141-155, 318-331).

Heavy applications (Galerkin chunks, eigensolver filters) run on device in
pair form; the per-aggregate QR, the small Ritz problems and the coarsest
inverse run on the host -- all are tiny one-time costs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg.hierarchy import (
    BlockProlongator,
    BlockStencilOperator,
    DenseOperator,
    Hierarchy,
    MGLevel,
    pack_grouped,
)
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.dirac import (
    PairStencilOperator,
    StencilOperator,
    gamma3_pair,
    pair_operator,
)
from deflatedmlmc_schwinger_tpu.solvers.eigs import (
    chebyshev_filtered_smallest,
    smallest_eigpairs_nonhermitian,
)


def p_blocks_host(tv: np.ndarray, L: int, phase_period: int) -> np.ndarray:
    """Host (na, L, 2k) complex prolongator blocks from test vectors tv (n, k):
    per-aggregate spin-phase column split + batched QR (the reference's
    Python quad loops + CGS, multigrid.py:192-259)."""
    n, k = tv.shape
    if n % L:
        raise ValueError(f"lattice size {n} not divisible by aggregate size {L}")
    na = n // L
    T = tv.reshape(na, L, k)
    pos = np.arange(L)
    g0 = np.where((pos % phase_period) < (phase_period // 2))[0]
    g1 = np.where((pos % phase_period) >= (phase_period // 2))[0]
    blocks = np.zeros((na, L, 2 * k), dtype=np.complex128)
    for idx, off in ((g0, 0), (g1, k)):
        sub = T[:, idx, :]                       # (na, L/2, k)
        Q, R = np.linalg.qr(sub)
        d = np.diagonal(R, axis1=-2, axis2=-1)   # (na, k)
        phase = np.where(np.abs(d) > 0, d / np.maximum(np.abs(d), 1e-300), 1.0)
        Q = Q * np.conj(phase)[:, None, :]
        blocks[:, idx[:, None], off + np.arange(k)[None, :]] = Q
    return blocks


def build_P_blocks(tv: np.ndarray, L: int, phase_period: int, rdtype) -> BlockProlongator:
    """Build the block prolongator from host test vectors tv (n, k)."""
    blocks = p_blocks_host(tv, L, phase_period)
    return BlockProlongator(
        blocks=CP(
            jnp.asarray(blocks.real.astype(np.dtype(rdtype))),
            jnp.asarray(blocks.imag.astype(np.dtype(rdtype))),
        )
    )


import functools

import jax


@jax.jit
def _galerkin_stripe(op, P: BlockProlongator, c) -> CP:
    """One within-aggregate column group of C = P^H A P: the basis vectors
    {P e_{(j,c)}}_j have disjoint support, so one (na, n) pair batch matvec
    produces a full column stripe. Returns RY (na, nc) with
    RY[j_col, j_row*dc + c_row] = C[j_row*dc + c_row, j_col*dc + c]."""
    na, L, dc = P.blocks.re.shape
    n = na * L
    ar = jnp.arange(na)[:, None]
    cols = jnp.arange(L)[None, :] + ar * L          # (na, L) flat support of agg j
    bc = jax.lax.dynamic_slice_in_dim(P.blocks.re, c, 1, axis=2)[:, :, 0]
    bs = jax.lax.dynamic_slice_in_dim(P.blocks.im, c, 1, axis=2)[:, :, 0]
    Xr = jnp.zeros((na, n), bc.dtype).at[ar, cols].set(bc)
    Xi = jnp.zeros((na, n), bs.dtype).at[ar, cols].set(bs)
    Y = op.matvec(CP(Xr, Xi))                        # (na, n) pair
    return P.apply_adjoint(Y)                        # (na, nc)


def _galerkin_stack(op, P: BlockProlongator) -> CP:
    """Device stack S (dc, na, nc) of all column stripes of C = P^H A P."""
    na, L, dc = P.blocks.re.shape
    stripes = [_galerkin_stripe(op, P, jnp.int32(c)) for c in range(dc)]
    return CP(
        jnp.stack([s.re for s in stripes]), jnp.stack([s.im for s in stripes])
    )


@jax.jit
def _block_norms(S: CP) -> jnp.ndarray:
    """Frobenius norm of each (dc, dc) block of C from the stripe stack:
    norms[j_row, j_col]."""
    dc, na, nc = S.re.shape
    T = S.reshape((dc, na, na, dc))          # [c_col, j_col, j_row, c_row]
    return jnp.sqrt(jnp.sum(T.re**2 + T.im**2, axis=(0, 3))).T


@functools.partial(jax.jit, static_argnames=("offsets",))
def _gather_blocks(S: CP, offsets: tuple) -> CP:
    """blocks[j, k] = C block (j, (j+offsets[k]) % na) from the stripe stack;
    returns (na, K, dc, dc) -- the BlockStencilOperator payload."""
    dc, na, nc = S.re.shape
    T = S.reshape((dc, na, na, dc))
    # -> [j_col, j_row, c_row, c_col]
    Tp = CP(jnp.transpose(T.re, (1, 2, 3, 0)), jnp.transpose(T.im, (1, 2, 3, 0)))
    rows = jnp.arange(na)
    outs = []
    for off in offsets:
        idx = (rows + off) % na
        outs.append(CP(Tp.re[idx, rows], Tp.im[idx, rows]))  # (na, dc, dc)
    return CP(
        jnp.stack([o.re for o in outs], axis=1),
        jnp.stack([o.im for o in outs], axis=1),
    )


def _dense_from_stack(S: CP) -> np.ndarray:
    """Host complex (nc, nc) coarse matrix from the stripe stack."""
    dc, na, nc = S.re.shape
    T = cplx.to_complex(S).reshape(dc, na, na, dc)   # [c_col, j_col, j_row, c_row]
    return T.transpose(2, 3, 1, 0).reshape(nc, nc)


def galerkin_coarse(op, P: BlockProlongator, rdtype) -> np.ndarray:
    """Host complex coarse operator C = P^H A P (dense pull; used for the
    coarsest level and as the block-structure fallback)."""
    return _dense_from_stack(_galerkin_stack(op, P))


def galerkin_block_stencil(
    op, P: BlockProlongator, rdtype, max_offsets: int = 48
) -> Optional[BlockStencilOperator]:
    """Coarse operator C = P^H A P directly as a cyclic block stencil,
    computed and sparsity-detected on device.

    Only the (na, na) block-norm map and the ~K nonzero (dc, dc) blocks ever
    go to the host, instead of the dense (nc, nc) coarse matrix.
    Returns None when the coupling pattern is not small-cyclic.
    """
    na, L, dc2 = P.blocks.re.shape
    S = _galerkin_stack(op, P)
    norms = np.asarray(_block_norms(S))              # (na, na) host, small
    scale = float(norms.max())
    j1, j2 = np.nonzero(norms > 1e-12 * max(scale, 1e-30))
    offsets = tuple(sorted({int((b - a) % na) for a, b in zip(j1, j2)}))
    if len(offsets) > max_offsets:
        return None
    blocks = _gather_blocks(S, offsets)
    return pack_grouped(BlockStencilOperator(blocks=blocks, offsets=offsets))


def _test_vectors(
    op, k: int, cfg: TraceConfig, seed: int, tol: float,
    V0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Near-kernel test vectors of the level pair operator (reference modes
    'EVs' | 'LSVs' | 'RSVs', multigrid.py:159-188). Returns host (n, k).

    ``V0`` warm-starts the subspace iteration (MG setup passes the restricted
    finer-level test vectors: tv is in range(P) by construction, so R tv is
    an approximate near-kernel of the Galerkin coarse operator)."""
    import jax

    mode = cfg.test_vectors_type
    rdtype = op.dtype
    # jitted closures: eigensolver phases apply these EAGERLY (power bound,
    # Ritz residuals); unjitted, every roll/einsum in the operator is a
    # separate dispatch
    mvA = jax.jit(op.matvec)
    mvQ = jax.jit(lambda v: gamma3_pair(op.matvec(v)))
    rounds = cfg.subspace_iters
    if V0 is not None:
        rounds = (cfg.subspace_iters_coarse
                  if cfg.subspace_iters_coarse is not None
                  else max(2, cfg.subspace_iters // 2))
    if mode in ("RSVs", "LSVs"):
        res = chebyshev_filtered_smallest(
            mvQ, op.n, k, rdtype=rdtype, seed=seed,
            degree=cfg.chebyshev_degree, rounds=rounds, tol=tol, V0=V0,
        )
        V = res.vectors
        if mode == "LSVs":
            half = V.shape[0] // 2
            V = np.concatenate([V[:half], -V[half:]], axis=0)
        return V
    elif mode == "EVs":
        _, V = smallest_eigpairs_nonhermitian(
            mvA, mvQ, op.n, k, rdtype=rdtype, seed=seed,
            degree=cfg.chebyshev_degree, rounds=rounds, V0=V0,
        )
        return V
    raise ValueError(f"unknown test_vectors_type {mode!r}")


def setup_hierarchy(
    op0,
    cfg: TraceConfig,
    *,
    key=None,  # retained for API compatibility; seeding is cfg.seed-derived
) -> Hierarchy:
    """Build the multigrid hierarchy for the fine operator op0
    (StencilOperator or PairStencilOperator).

    Dispatches on cfg.setup_backend: 'host' runs the numpy/scipy twin
    (mg/host_setup.py, the default), 'device' runs the
    CheFSI/Galerkin phases below on the accelerator."""
    if cfg.setup_backend == "host":
        from deflatedmlmc_schwinger_tpu.mg.host_setup import setup_hierarchy_host

        hier = setup_hierarchy_host(op0, cfg)
        # the quality flag is honored at the DISPATCH level so both backends
        # run the same invariant checks (reference: multigrid.py:282-316 runs
        # them whenever the flag is set, regardless of how setup was done)
        if cfg.check_quality_MG:
            for name, val in check_quality(hier).items():
                print(f"\t{name} = {val:.3e}")
        return hier
    if cfg.setup_backend != "device":
        raise ValueError(
            f"setup_backend must be 'host' or 'device', got {cfg.setup_backend!r}"
        )
    if isinstance(op0, StencilOperator):
        op0 = pair_operator(op0)
    rdtype = op0.dtype
    dof = list(cfg.dof)
    aggrs = list(cfg.aggrs)
    max_levels = int(cfg.max_nr_levels)
    if dof[0] != 2:
        raise ValueError("dof[0] must be 2 (spin components)")
    if cfg.accuracy_mg_eigvs not in ("low", "high"):
        # reference raises for unknown accuracy too (multigrid.py:164-171)
        raise ValueError(
            f"accuracy_mg_eigvs must be 'low' or 'high', got {cfg.accuracy_mg_eigvs!r}"
        )
    eig_tol = 1.0e-3 if cfg.accuracy_mg_eigvs == "low" else 1.0e-9

    levels: List[MGLevel] = []
    cur_op = op0
    # level-0 displacement shift (reference: multigrid.py:148-150)
    perm_shift = 2 * cfg.nt * cfg.x_displacement if cfg.use_permuted else 0

    tv_warm: Optional[np.ndarray] = None
    for i in range(max_levels - 1):
        L = aggrs[i] * dof[i]
        phase_period = dof[i] if i == 0 else dof[i] // 2
        k = dof[i + 1] // 2
        tv = _test_vectors(cur_op, k, cfg, cfg.seed + 977 * i, eig_tol,
                           V0=tv_warm)
        P = build_P_blocks(tv, L, phase_period, rdtype)
        levels.append(MGLevel(op=cur_op, P=P, perm_shift=perm_shift))
        # warm start for the next level's test vectors: tv in range(P), so
        # R tv is an approximate near-kernel of the coarse Galerkin operator
        tv_warm = np.asarray(
            cplx.to_complex(
                P.apply_adjoint(
                    CP(jnp.asarray(np.ascontiguousarray(tv.real.T), rdtype),
                       jnp.asarray(np.ascontiguousarray(tv.imag.T), rdtype))
                )
            ).T
        )
        # coarse-level shift (reference: multigrid.py:321-326)
        perm_shift = (perm_shift // L) * dof[i + 1] if cfg.use_permuted else 0
        is_coarsest = i + 1 == max_levels - 1
        prev_op, cur_op = cur_op, None
        if not is_coarsest and cfg.coarse_format == "auto":
            # device-side Galerkin + sparsity detection: only the nonzero
            # blocks go to the host
            cur_op = galerkin_block_stencil(prev_op, P, rdtype)
        if cur_op is None:
            C = galerkin_coarse(prev_op, P, rdtype)
            cur_op = DenseOperator(
                mat=CP(
                    jnp.asarray(C.real.astype(np.dtype(rdtype))),
                    jnp.asarray(C.imag.astype(np.dtype(rdtype))),
                )
            )
            if is_coarsest:
                coarsest_dense = C

    levels.append(MGLevel(op=cur_op, P=None, perm_shift=perm_shift))
    Cinv = np.linalg.inv(coarsest_dense)
    coarsest_inv = CP(
        jnp.asarray(Cinv.real.astype(np.dtype(rdtype))),
        jnp.asarray(Cinv.imag.astype(np.dtype(rdtype))),
    )
    hier = Hierarchy(levels=tuple(levels), coarsest_inv=coarsest_inv)
    if cfg.check_quality_MG:
        for name, val in check_quality(hier).items():
            print(f"\t{name} = {val:.3e}")
    return hier


def check_quality(hier: Hierarchy) -> Dict[str, float]:
    """The reference's opt-in invariant checks (multigrid.py:282-316):
    orthonormality ||RP - I||_F, gamma3-compatibility of P, Hermiticity of
    A_{l+1} and gamma3*A_{l+1} (host)."""
    out: Dict[str, float] = {}
    for i, lev in enumerate(hier.levels[:-1]):
        b = cplx.to_complex(lev.P.blocks)
        na, L, dc = b.shape
        gram = np.einsum("alk,alm->akm", np.conj(b), b)
        eye = np.eye(dc)
        out[f"orthonormality of P at level {i}"] = float(
            np.sqrt(np.sum(np.abs(gram - eye[None]) ** 2))
        )
        # gamma3-compat: strips never straddle the spin half, and the coarse
        # layout is aggregate-major, so fine and coarse per-strip signs agree
        fine_sign = np.where(np.arange(na) < na // 2, 1.0, -1.0)
        coarse_sign = fine_sign
        mism = (fine_sign - coarse_sign)[:, None, None] * b
        out[f"g3-compatibility at level {i}"] = float(
            np.sqrt(np.sum(np.abs(mism) ** 2))
        )
        Ac = hier.levels[i + 1].op.complex_matrix()
        out[f"hermiticity of A at level {i+1}"] = float(
            np.linalg.norm(Ac - Ac.conj().T)
        )
        half = Ac.shape[0] // 2
        g3Ac = np.concatenate([Ac[:half], -Ac[half:]], axis=0)
        out[f"hermiticity of g3*A at level {i+1}"] = float(
            np.linalg.norm(g3Ac - g3Ac.conj().T)
        )
    return out
