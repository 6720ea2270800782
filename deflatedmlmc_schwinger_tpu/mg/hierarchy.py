"""Containers for the multigrid hierarchy (the reference's LevelML/SimpleML,
multigrid.py:26-48, re-designed as JAX pytrees).

All device data is held as CP (re, im) real pairs (see ops/cplx.py for why):
  * level 0: the 9-point PairStencilOperator (ops/dirac.py);
  * coarse levels: DenseOperator -- coarse matrices are small (8192^2 and
    below for the shipped configs) and the pair matvec is four real
    matmuls.

Prolongators are stored as per-aggregate dense blocks (n_aggr, L, 2k):
aggregation is a partition of the flat index space into contiguous strips of
length L that never straddle the spin boundary, so P is block-diagonal over
strips and applying P / R = P^H is one batched (pair) einsum -- no
gather/scatter and no CSR anywhere on device (the reference's Python
quad-loop P assembly + CGS is multigrid.py:192-259).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.pytree import pytree_dataclass, static_field


@pytree_dataclass
class DenseOperator:
    """Dense coarse-level operator; pair matvec = 4 real matmuls."""

    mat: CP  # pair of (n, n)

    @property
    def n(self) -> int:
        return self.mat.re.shape[0]

    @property
    def dtype(self):
        return self.mat.re.dtype

    def matvec(self, v: CP) -> CP:
        return cplx.matmul_right(v, self.mat)

    def complex_matrix(self) -> np.ndarray:
        return cplx.to_complex(self.mat)


@pytree_dataclass
class BlockStencilOperator:
    """Coarse operator as a cyclic block stencil.

    Galerkin coarse operators inherit the lattice's cyclic coupling
    structure: block-row j couples only to block-columns (j + o) mod nac for
    a small static offset set (aggregate strips are adjacent in t, x, and
    across the spin halves). Storing only those blocks cuts the level-1
    matvec from a dense 8192^2 read (~512 MB/apply) to ~K*nac*dc^2 (~10 MB)
    -- the memory-bandwidth win that makes coarse V-cycle levels cheap.

    blocks[j, k] is the (dc, dc) coupling of block-row j to block-column
    (j + offsets[k]) mod nac; the matvec is K rolls + batched pair einsums
    (loop-safe everywhere).

    ``gmat``/``gwin``: optional grouped-band packing (pack_grouped): block
    rows are grouped G at a time and each group's band becomes one dense
    (K_win, G*dc) matrix, so the matvec is a batch of matmuls with
    N = G*dc = 128 output columns instead of per-block contractions with
    N = dc = 16.
    """

    blocks: CP  # (nac, K, dc, dc)
    offsets: Tuple[int, ...] = static_field(())
    gmat: Optional[CP] = None        # (ngroups, nwin*dc, G*dc) packed bands
    gwin: Optional[jnp.ndarray] = None  # (ngroups, nwin) int32 block columns
    G: int = static_field(0)

    @property
    def n(self) -> int:
        return self.blocks.re.shape[0] * self.blocks.re.shape[2]

    @property
    def dtype(self):
        return self.blocks.re.dtype

    def matvec(self, v: CP) -> CP:
        """Grouped-band batched matmul when packed; otherwise one gather +
        one einsum (not K rolls + 4K einsums: the roll form costs ~70
        dispatches per apply)."""
        import numpy as np

        nac, K, dc, _ = self.blocks.re.shape
        batch = v.re.shape[:-1]
        xa = v.reshape(batch + (nac, dc))
        if self.gmat is not None:
            ngroups, nwin = self.gwin.shape
            xw = CP(xa.re[..., self.gwin, :], xa.im[..., self.gwin, :])
            xw = xw.reshape(batch + (ngroups, nwin * dc))
            out = cplx.einsum2("...gk,gkn->...gn", xw, self.gmat)
            return out.reshape(batch + (nac * dc,))
        idx = (np.arange(nac)[None, :] + np.asarray(self.offsets)[:, None]) % nac
        xg = CP(xa.re[..., idx, :], xa.im[..., idx, :])   # (..., K, nac, dc)
        out = cplx.einsum2("akij,...kaj->...ai", self.blocks, xg)
        return out.reshape(batch + (nac * dc,))

    def complex_matrix(self) -> np.ndarray:
        b = cplx.to_complex(self.blocks)
        nac, K, dc, _ = b.shape
        n = nac * dc
        C = np.zeros((n, n), dtype=b.dtype)
        for j in range(nac):
            for k, off in enumerate(self.offsets):
                j2 = (j + off) % nac
                C[j * dc : (j + 1) * dc, j2 * dc : (j2 + 1) * dc] = b[j, k]
        return C


def pack_grouped(
    op: BlockStencilOperator, group: int = 8, max_fill: float = 4.0,
    host_blocks: Optional[np.ndarray] = None,
) -> BlockStencilOperator:
    """Pack a cyclic block stencil into grouped-band matrices.

    Block rows are grouped ``group`` at a time; the offsets are clustered on
    the cyclic index circle (the Galerkin operators of this problem couple
    within a small band around 0 plus a band around nac/2 -- the spin
    halves), and each cluster contributes a contiguous window of block
    columns per group. The matvec then contracts the gathered window
    (nwin*dc) against one (nwin*dc, G*dc) matrix per group: N = G*dc = 128
    output columns where the per-block form has N = dc = 16.

    The packed form pads the band with zeros (window overlap + cluster
    fill); packing is skipped when the padded work exceeds ``max_fill``
    times the exact block count, or when the grouping does not divide nac.
    Host-side, one-time, exact (tests/test_mg.py packed-vs-unpacked).

    ``host_blocks``: the numpy complex (nac, K, dc, dc) blocks when the
    caller built them on the host -- avoids a device->host download of
    ``op.blocks``."""
    import numpy as np

    nac, K, dc, _ = op.blocks.re.shape
    G = int(group)
    if op.gmat is not None or nac % G or nac < 2 * G:
        return op
    offs = sorted(int(o) % nac for o in op.offsets)
    # cluster cyclically: split where the gap between consecutive offsets
    # exceeds G (separate windows are then cheaper than one merged band)
    gaps = [(offs[(i + 1) % len(offs)] - offs[i]) % nac for i in range(len(offs))]
    splits = [i for i, g in enumerate(gaps) if g > G]
    if not splits:                       # one dense ring -> nothing to win
        return op
    clusters = []
    start = (splits[-1] + 1) % len(offs)
    ordered = offs[start:] + offs[:start]
    cur = [ordered[0]]
    for o in ordered[1:]:
        if (o - cur[-1]) % nac > G:
            clusters.append(cur)
            cur = [o]
        else:
            cur.append(o)
    clusters.append(cur)
    # window of relative block columns per cluster: [c0, c0 + span + G - 1]
    rel = []
    for c in clusters:
        c0 = c[0]
        span = (c[-1] - c0) % nac + 1
        rel.extend(((c0 + j) % nac) for j in range(span + G - 1))
    nwin = len(rel)
    if nwin * dc > max_fill * K * dc or nwin >= nac:
        return op
    ngroups = nac // G
    rel_arr = np.asarray(rel)
    gwin = (np.arange(ngroups)[:, None] * G + rel_arr[None, :]) % nac
    # column w of group g holds block column gwin[g, w]; place blocks[a, k]
    # at [w*dc + j, r*dc + i] (out = x_window @ gmat)
    wpos = {int(r): w for w, r in enumerate(rel_arr)}
    B = (np.asarray(host_blocks) if host_blocks is not None
         else np.asarray(cplx.to_complex(op.blocks)))
    gmat = np.zeros((ngroups, nwin * dc, G * dc), dtype=B.dtype)
    for r in range(G):
        for k, off in enumerate(op.offsets):
            w_rel = (np.asarray(off) + r) % nac
            w = wpos[int(w_rel)]
            blk = B[np.arange(ngroups) * G + r, k]          # (ngroups, dc, dc)
            gmat[:, w * dc:(w + 1) * dc, r * dc:(r + 1) * dc] = (
                blk.transpose(0, 2, 1)
            )
    rdt = np.dtype(op.blocks.re.dtype)
    return BlockStencilOperator(
        blocks=op.blocks,
        offsets=op.offsets,
        gmat=CP(jnp.asarray(gmat.real.astype(rdt)),
                jnp.asarray(gmat.imag.astype(rdt))),
        gwin=jnp.asarray(gwin.astype(np.int32)),
        G=G,
    )


def block_stencil_from_dense(
    C: np.ndarray, dc: int, rdtype, max_offsets: int = 48
) -> Optional[BlockStencilOperator]:
    """Detect the cyclic block-offset structure of a dense coarse matrix and
    pack it; returns None when the pattern is not small-cyclic (fallback to
    DenseOperator)."""
    import jax.numpy as jnp

    n = C.shape[0]
    if n % dc:
        return None
    nac = n // dc
    Cb = C.reshape(nac, dc, nac, dc).transpose(0, 2, 1, 3)  # (nac, nac, dc, dc)
    norms = np.abs(Cb).reshape(nac, nac, -1).max(axis=-1)
    j1, j2 = np.nonzero(norms)
    offsets = sorted({int((b - a) % nac) for a, b in zip(j1, j2)})
    if len(offsets) > max_offsets:
        return None
    blocks = np.zeros((nac, len(offsets), dc, dc), dtype=C.dtype)
    rows = np.arange(nac)
    for k, off in enumerate(offsets):
        blocks[:, k] = Cb[rows, (rows + off) % nac]
    return pack_grouped(BlockStencilOperator(
        blocks=CP(
            jnp.asarray(blocks.real.astype(np.dtype(rdtype))),
            jnp.asarray(blocks.imag.astype(np.dtype(rdtype))),
        ),
        offsets=tuple(offsets),
    ), host_blocks=blocks)


@pytree_dataclass
class BlockProlongator:
    """Aggregation prolongator as dense per-aggregate blocks (pair).

    blocks[j] is the (L, 2k) orthonormal-column block of aggregate j; the
    coarse index layout is j*(2k) + g*k + c (aggregate-major, matching the
    reference's jj_ptr = j*dofip1*2 + g*dofip1 + k, multigrid.py:214,226).
    """

    blocks: CP  # pair of (n_aggr, L, 2k)

    @property
    def n_fine(self) -> int:
        return self.blocks.re.shape[0] * self.blocks.re.shape[1]

    @property
    def n_coarse(self) -> int:
        return self.blocks.re.shape[0] * self.blocks.re.shape[2]

    def apply(self, y: CP) -> CP:
        """P @ y for flat pair coarse vectors y of shape (..., n_coarse)."""
        na, L, dc = self.blocks.re.shape
        ya = y.reshape(y.re.shape[:-1] + (na, dc))
        out = cplx.einsum2("alk,...ak->...al", self.blocks, ya)
        return out.reshape(y.re.shape[:-1] + (na * L,))

    def apply_adjoint(self, x: CP) -> CP:
        """R @ x = P^H @ x for flat pair fine vectors x of shape (..., n_fine)."""
        na, L, dc = self.blocks.re.shape
        xa = x.reshape(x.re.shape[:-1] + (na, L))
        out = cplx.einsum2_conj_a("alk,...al->...ak", self.blocks, xa)
        return out.reshape(x.re.shape[:-1] + (na * dc,))

    def to_dense(self) -> np.ndarray:
        """Materialize P as a host complex (n_fine, n_coarse) matrix (tests)."""
        b = cplx.to_complex(self.blocks)
        na, L, dc = b.shape
        P = np.zeros((na * L, na * dc), dtype=b.dtype)
        for j in range(na):
            P[j * L : (j + 1) * L, j * dc : (j + 1) * dc] = b[j]
        return P


@pytree_dataclass
class MGLevel:
    """One level: its operator, the prolongator to the next coarser level,
    and the displacement shift for the permuted (displaced-trace) observable."""

    op: Any                                  # PairStencilOperator | DenseOperator
    P: Optional[BlockProlongator]            # None on the coarsest level
    perm_shift: int = static_field(0)

    @property
    def n(self) -> int:
        return self.op.n


@pytree_dataclass
class Hierarchy:
    levels: Tuple[MGLevel, ...]
    coarsest_inv: CP  # pair dense inverse of the coarsest operator
    # GMRES-residual-polynomial smoother roots per non-coarsest level,
    # precomputed at setup when the hierarchy is built host-side (None ->
    # MGSolver computes them lazily with device matvecs). Static metadata:
    # tuple of tuples of complex.
    poly_roots: Optional[Tuple[Tuple[complex, ...], ...]] = static_field(None)
    # Same, for a SECOND smoother depth (config.py defl_solver: the
    # deflation-setup solver may smooth at a different depth than the
    # sampling solver; without precomputed roots its MGSolver would fall
    # back to gmres_poly_roots' host-side Arnoldi, ~12 sequential device
    # round-trips).
    poly_roots_extra: Optional[Tuple[Tuple[complex, ...], ...]] = static_field(None)

    @property
    def nr_levels(self) -> int:
        return len(self.levels)

    def sizes(self) -> Tuple[int, ...]:
        return tuple(lev.n for lev in self.levels)
