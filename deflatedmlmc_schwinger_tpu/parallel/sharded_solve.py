"""Lattice-sharded production MG solve (SURVEY.md P3 / section 5.7 fully
wired): the complete V-cycle-preconditioned batched FGMRES runs under
``shard_map`` on a ('samples', 'x') mesh with the FINE level domain-decomposed
over the x axis. This is the reference's only hot kernel -- the CSR SpMV
inside MG.solve (reference: multigrid.py:552-557, 347-366) -- scaled past one
chip for the 256^2/512^2 lattices.

Design (hand-written SPMD, the shape GSPMD cannot infer for a whole Krylov
solver):

  * fine-level matvec: the explicit halo-exchange stencil kernel
    (parallel/halo.py) -- one boundary row per neighbor per apply over the
    x ring, computed on shard-local (B, 2, X/k, T) grids;
  * fine-level smoothing: the GMRES-polynomial smoother needs ZERO inner
    products (mg/cycle.py), so it is embarrassingly shard-local; the
    adaptive 'gmres' smoother psums its dots over the x axis;
  * P / R stay shard-local: aggregates are contiguous t-strips inside one
    (spin, x) row (aggregate j = (s, x, t-block), mg/setup.py), so the
    prolongator blocks reshape to (2, X, T/L, L, dc) and shard over X with
    the lattice. Restriction all_gathers the (tiny) coarse vector once so
    coarse levels are replicated; prolongation slices the shard's x-range
    back out;
  * coarse levels: replicated compute (identical on every shard, no
    communication) reusing the exact same V-cycle code as the single-chip
    path (mg/cycle.py build_v_cycle);
  * outer FGMRES: solvers/fgmres.py with axis_name='x' -- every norm and
    Arnoldi dot psums its shard-local partial sum, so the convergence
    control flow is replicated across shards by construction.

Per outer iteration the x-axis communication is: 2 boundary rows per stencil
apply (halo) + one all_gather of the coarse RHS + the scalar psums -- the
provable minimum for this decomposition.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deflatedmlmc_schwinger_tpu.config import SolverConfig
from deflatedmlmc_schwinger_tpu.mg.cycle import (
    GmresSmoother,
    PolySmoother,
    build_v_cycle,
    gmres_poly_roots,
    gmres_smoother,
    poly_smoother,
)
from deflatedmlmc_schwinger_tpu.mg.hierarchy import Hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.dirac import PairStencilOperator
from deflatedmlmc_schwinger_tpu.parallel.halo import _halo_kernel
from deflatedmlmc_schwinger_tpu.parallel.mesh import replicate, spans_processes
from deflatedmlmc_schwinger_tpu.solvers.fgmres import FGMRESResult, fgmres


def _put(a, mesh: Mesh, spec: P):
    """Place an array on the mesh; multi-process meshes assemble the global
    array from the locally identical host value."""
    sharding = NamedSharding(mesh, spec)
    if spans_processes(mesh):
        host = np.asarray(a)
        return jax.make_array_from_callback(host.shape, sharding,
                                            lambda idx: host[idx])
    return jax.device_put(a, sharding)


class ShardedMGSolver:
    """Batched fine-level MG-FGMRES with the lattice sharded over a mesh
    x axis (and probes over the samples axis). Drop-in for MGSolver.solve at
    level 0; coarse-level solves stay on the replicated MGSolver."""

    def __init__(
        self,
        hier: Hierarchy,
        mesh: Mesh,
        cfg: Optional[SolverConfig] = None,
        *,
        x_axis: str = "x",
        sample_axis: str = "samples",
    ):
        self.cfg = cfg or SolverConfig()
        self.mesh = mesh
        self.x_axis = x_axis
        self.sample_axis = sample_axis
        op0 = hier.levels[0].op
        if not isinstance(op0, PairStencilOperator):
            raise TypeError("sharded solve needs a PairStencilOperator fine level")
        self.nx, self.nt = op0.nx, op0.nt
        self.n = op0.n
        nshards = mesh.shape[x_axis]
        if self.nx % nshards:
            raise ValueError(f"nx={self.nx} not divisible by {nshards} x-shards")
        self.nshards = nshards

        P0 = hier.levels[0].P
        na, L, dc = P0.blocks.re.shape
        if self.nt % L or na != 2 * self.nx * (self.nt // L):
            raise ValueError(
                "aggregates must be contiguous t-strips inside one (spin, x) "
                f"row: n_aggr={na}, L={L}, lattice {self.nx}x{self.nt}"
            )
        tb = self.nt // L
        self.nc = na * dc
        # aggregate j = (s, x, t-block): reshape blocks so X shards with the
        # lattice and each shard owns exactly its aggregates' columns
        p5 = P0.blocks.reshape((2, self.nx, tb, L, dc))
        pspec = P(None, x_axis, None, None, None)
        self._p5 = CP(_put(p5.re, mesh, pspec), _put(p5.im, mesh, pspec))
        cspec = P(None, None, None, x_axis, None)
        self._coeffs = CP(
            _put(op0.coeffs.re, mesh, cspec),
            _put(op0.coeffs.im, mesh, cspec),
        )
        self._coarse = replicate(
            Hierarchy(levels=hier.levels[1:], coarsest_inv=hier.coarsest_inv),
            mesh,
        )
        # same bookkeeping as MGSolver (lazy device scalars; see mg/cycle.py)
        self.num_iters = 0
        self.coarsest_lev_iters = [0] * hier.nr_levels
        self.total_solve_calls = 0

        # smoothers: poly = zero inner products (fully shard-local); gmres =
        # psum'd dots on the fine level, plain dots on replicated coarse ones
        smooth_iters = self.cfg.smooth_iters
        if self.cfg.smoother == "poly":
            pre = hier.poly_roots
            roots = [
                (np.asarray(pre[i]) if (pre is not None and i < len(pre)
                                        and len(pre[i]) == smooth_iters)
                 else gmres_poly_roots(
                     jax.jit(lev.op.matvec), lev.n, lev.op.dtype, smooth_iters
                 ))
                for i, lev in enumerate(hier.levels[:-1])
            ]
            # shard-local matvec (the halo matvec, not op.matvec, is the
            # operator inside shard_map)
            self._sm0 = lambda mv, r: poly_smoother(mv, r, roots[0])
            self._sm0_res = lambda mv, b: poly_smoother(
                mv, b, roots[0], with_residual=True
            )
            self._coarse_sms = [PolySmoother(th) for th in roots[1:]]
        else:
            # level-0 smooths over the HALO matvec function (not an op
            # object -- the smoother-object interface takes ops since the
            # ctx refactor, so bind the raw kernels here)
            def _g0(mv, r):
                return gmres_smoother(mv, r, smooth_iters, x_axis)

            def _g0_res(mv, b):
                x = _g0(mv, b)
                return x, b - mv(x)

            self._sm0 = _g0
            self._sm0_res = _g0_res
            self._coarse_sms = [GmresSmoother(smooth_iters)] * (
                len(hier.levels) - 2
            )

        self._kernels = {}

    # -- the SPMD program ----------------------------------------------------
    def _build(self, restart: int, max_restarts: int):
        key = (restart, max_restarts)
        if key in self._kernels:
            return self._kernels[key]
        x_axis = self.x_axis
        nshards = self.nshards
        nx, nt, nc = self.nx, self.nt, self.nc
        Xl = nx // nshards
        sm0 = self._sm0
        sm0_res = self._sm0_res
        coarse_sms = self._coarse_sms
        cfg = self.cfg

        def kernel(coeffs: CP, p5: CP, coarse: Hierarchy, b: CP, tol_eff):
            # b arrives as the local grid block (B_loc, 2, Xl, T)
            B = b.re.shape[0]
            n_loc = 2 * Xl * nt

            def mv0(v: CP) -> CP:
                g = v.reshape((v.re.shape[0], 2, Xl, nt))
                yr, yi = _halo_kernel(
                    coeffs.re, coeffs.im, g.re, g.im,
                    x_axis=x_axis, nshards=nshards,
                )
                return CP(yr, yi).reshape(v.re.shape)

            _, _, tb, L, dc = p5.re.shape

            def restrict0(v: CP) -> CP:
                """R0 v: shard-local block contraction, then assemble the
                replicated coarse vector with ONE all_gather over x."""
                g = v.reshape((v.re.shape[0], 2, Xl, tb, L))
                c = cplx.einsum2_conj_a("sxtld,bsxtl->bsxtd", p5, g)
                full = CP(
                    lax.all_gather(c.re, x_axis, axis=2, tiled=True),
                    lax.all_gather(c.im, x_axis, axis=2, tiled=True),
                )
                return full.reshape((v.re.shape[0], nc))

            def prolong0(y: CP) -> CP:
                """P0 y: slice this shard's x-range of the replicated coarse
                vector, expand through the local blocks. Zero communication."""
                B_ = y.re.shape[0]
                g = y.reshape((B_, 2, nx, tb, dc))
                x0i = lax.axis_index(x_axis) * Xl
                loc = CP(
                    lax.dynamic_slice_in_dim(g.re, x0i, Xl, axis=2),
                    lax.dynamic_slice_in_dim(g.im, x0i, Xl, axis=2),
                )
                out = cplx.einsum2("sxtld,bsxtd->bsxtl", p5, loc)
                return out.reshape((B_, n_loc))

            coarse_v = build_v_cycle(coarse.levels, coarse.coarsest_inv, coarse_sms)

            def precond0(bv: CP) -> CP:
                # the level-0 V-cycle factors as smooth0 + P0 . (coarse
                # V-cycle) . R0 + post-smooth0 (mg/cycle.py build_v_cycle);
                # the descent residual falls out of the smoother recurrence
                x, r = sm0_res(mv0, bv)
                xc = coarse_v(restrict0(r))
                x = x + prolong0(xc)
                r = bv - mv0(x)
                return x + sm0(mv0, r)

            b_flat = b.reshape((B, n_loc))
            res = fgmres(
                mv0, b_flat, tol=tol_eff, restart=restart,
                max_restarts=max_restarts, precond=precond0,
                stall_ratio=cfg.stall_ratio, stall_cycles=cfg.stall_cycles,
                axis_name=x_axis,
                # ALL mesh axes: shards of different samples-rows must agree
                # on loop trip counts or the halo ring deadlocks (fgmres.py)
                pred_axis_names=tuple(self.mesh.axis_names),
            )
            # gather the solution back to the probes' layout (flat, sample-
            # sharded, x-replicated) INSIDE the program: the estimator's
            # <x, z> needs the full row anyway, and handing out x-sharded
            # arrays would leave every downstream eager op inserting its own
            # collectives (which deadlocks the in-process CPU communicator
            # and costs more launches than this single fused all_gather)
            xg = res.x.reshape((B, 2, Xl, nt))
            xf = CP(
                lax.all_gather(xg.re, x_axis, axis=2, tiled=True),
                lax.all_gather(xg.im, x_axis, axis=2, tiled=True),
            ).reshape((B, 2 * nx * nt))
            return xf, res.resnorm, res.bnorm, res.iters, res.cycles, res.stalled

        vspec = P(self.sample_axis, None, x_axis, None)
        sspec = P(self.sample_axis)
        cspec = P(None, None, None, x_axis, None)
        pspec = P(None, x_axis, None, None, None)
        # check_vma off: the fixed-size Krylov buffers initialize as
        # zeros inside the kernel, which the varying-axes inference marks
        # unvarying over 'samples' and then rejects as while_loop carries;
        # semantically every buffer is per-(sample, x-shard) local.
        mapped = jax.shard_map(
            kernel,
            mesh=self.mesh,
            in_specs=(cspec, pspec, P(), vspec, P()),
            out_specs=(P(self.sample_axis, None), sspec, sspec, sspec, P(), sspec),
            check_vma=False,
        )

        def outer(coeffs, p5, coarse, b_flat: CP, tol_eff):
            # grid reshape + lattice reshard INSIDE the one jitted program:
            # a solve is exactly one launch, so its collectives can never
            # interleave with another program's (the in-process CPU
            # communicator deadlocks on cross-program reordering, and one
            # fused launch is also the efficient shape on real meshes)
            B = b_flat.re.shape[0]
            g = b_flat.reshape((B, 2, nx, nt))
            return mapped(coeffs, p5, coarse, g, tol_eff)

        jitted = jax.jit(outer)
        self._kernels[key] = jitted
        return jitted

    def solve(self, b, tol: float, *, max_restarts: Optional[int] = None) -> FGMRESResult:
        """Solve A_0 x = b for flat pair right-hand sides b (B, n); the
        lattice resharding happens at this boundary (grid form, x-sharded)."""
        if not isinstance(b, CP):
            b = cplx.from_complex(np.asarray(b))
            b = b.astype(self._coeffs.re.dtype)
        tol_eff = self.cfg.effective_tol(tol, cplx.complex_dtype(b.re.dtype))
        fn = self._build(
            self.cfg.restart,
            self.cfg.max_restarts if max_restarts is None else int(max_restarts),
        )
        # normalize b's placement (no-op when the estimator already sample-
        # sharded it); the lattice reshard happens INSIDE the one launch
        bspec = P(self.sample_axis, None)
        if getattr(b.re, "is_fully_addressable", True):
            b = CP(_put(b.re, self.mesh, bspec), _put(b.im, self.mesh, bspec))
        out = fn(self._coeffs, self._p5, self._coarse, b,
                 jnp.asarray(tol_eff, b.re.dtype))
        # barrier on every backend: the virtual-device CPU communicator
        # deadlocks when a second distributed computation (e.g. the
        # estimator's eager <x, z>) interleaves with this program's
        # in-flight collectives, and no backend is relied on to order
        # collectives across programs. The mesh sampling loop fetches every
        # batch to the host right after, so the barrier adds no sync.
        jax.block_until_ready(out)
        x, resnorm, bnorm, iters, cycles, stalled = out
        it = jnp.max(iters)
        self.num_iters = it
        self.total_solve_calls += 1
        self.coarsest_lev_iters[0] = self.coarsest_lev_iters[0] + it
        return FGMRESResult(x=x, resnorm=resnorm, bnorm=bnorm, iters=iters,
                            cycles=cycles, stalled=stalled)
