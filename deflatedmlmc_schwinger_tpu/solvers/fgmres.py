"""Batched flexible GMRES on explicit (re, im) pairs, jitted, fixed-size
Krylov buffers.

Device replacement for the reference's outer Krylov solver -- pyamg
``fgmres`` around the V-cycle preconditioner (reference: multigrid.py:347-366).

All state is CP pairs of real arrays (ops/cplx.py). Complex Givens rotations,
the Arnoldi recurrence and the triangular solve are written in explicit pair
arithmetic (elementwise ops + real einsums only).

Solves a whole batch of right-hand sides (B, n) at once; the inner loop exits
as soon as every batch row converged; the outer loop recomputes the true
residual and restarts.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.cplx import CP


class FGMRESResult(NamedTuple):
    x: CP                   # (B, n) solution (pair)
    resnorm: jnp.ndarray    # (B,) final true residual norms
    bnorm: jnp.ndarray      # (B,) rhs norms
    iters: jnp.ndarray      # (B,) int32 Arnoldi steps per row
    cycles: jnp.ndarray     # () int32 restart cycles used
    stalled: jnp.ndarray = None  # (B,) bool: final residual above tol_abs


def _bc(s: CP) -> CP:
    """Broadcast a (B,) pair scalar over a trailing vector axis."""
    return CP(s.re[:, None], s.im[:, None])


def _psum(v, axis_name):
    return lax.psum(v, axis_name) if axis_name else v


def pdot(x: CP, y: CP, axis_name=None) -> CP:
    """<x, y> along the vector axis; inside shard_map the vector axis is
    lattice-sharded, so partial sums are psum'd over ``axis_name``."""
    d = cplx.cdot(x, y)
    return CP(_psum(d.re, axis_name), _psum(d.im, axis_name))


def pnorm(x: CP, axis_name=None) -> jnp.ndarray:
    return jnp.sqrt(_psum(cplx.norm2(x), axis_name))


def _gany(pred: jnp.ndarray, axes) -> jnp.ndarray:
    """Global any() of a boolean across mesh axes. Loop predicates MUST be
    identical on every device that participates in a collective inside the
    loop: a samples-row that converged earlier and stopped issuing the halo
    ppermute would deadlock the ring (observed on the CPU communicator;
    undefined behavior on any real interconnect)."""
    if not axes:
        return pred
    return lax.psum(pred.astype(jnp.float32), axes) > 0


def _givens(a: CP, b: CP):
    """Complex Givens rotation in pair arithmetic: c real, s pair with
    [c, s; -conj(s), c] @ [a, b]^T = [r, 0]^T."""
    eps = jnp.finfo(a.re.dtype).tiny
    na = cplx.cabs(a)
    nb = cplx.cabs(b)
    t = jnp.sqrt(na * na + nb * nb)
    t_safe = jnp.maximum(t, eps)
    na_safe = jnp.maximum(na, eps)
    c = na / t_safe
    phase = cplx.scale_real(a, 1.0 / na_safe)            # a / |a|
    s = cplx.scale_real(cplx.cmul(phase, b.conj()), 1.0 / t_safe)
    nb_safe = jnp.maximum(nb, eps)
    s_a0 = cplx.scale_real(b.conj(), 1.0 / nb_safe)      # a == 0 case
    s = cplx.where(na > 0, s, s_a0)
    c = jnp.where(na > 0, c, 0.0)
    c = jnp.where(t > 0, c, 1.0)
    s = cplx.where(t > 0, s, cplx.CP(jnp.zeros_like(s.re), jnp.zeros_like(s.im)))
    r = CP(c * a.re, c * a.im) + cplx.cmul(s, b)
    return c, s, r


def _rot_apply(c, s: CP, hi: CP, hip1: CP):
    """Apply [c, s; -conj(s), c] to the pair (hi, hip1)."""
    new_i = CP(c * hi.re, c * hi.im) + cplx.cmul(s, hip1)
    new_ip1 = CP(c * hip1.re, c * hip1.im) - cplx.cmul(s.conj(), hi)
    return new_i, new_ip1


def _cp_set(arr: CP, idx, val: CP) -> CP:
    return CP(arr.re.at[idx].set(val.re), arr.im.at[idx].set(val.im))


@functools.partial(
    jax.jit,
    static_argnames=(
        "matvec", "precond", "matvec_precond", "restart", "max_restarts",
        "stall_ratio", "stall_cycles", "axis_name", "pred_axis_names",
    ),
)
def _fgmres_impl(matvec, precond, b: CP, x0: CP, tol_abs, restart,
                 max_restarts, stall_ratio, stall_cycles, axis_name=None,
                 pred_axis_names=(), matvec_precond=None, ctx=None):
    # ``ctx``: optional pytree threaded to matvec/precond as their first
    # argument. This is how the MG hierarchy enters the program as jit
    # ARGUMENTS instead of closure-captured constants: with constants, the
    # serialized executable embeds every level operator (149 MB for the
    # 512^2 hierarchy) and ANY change to the hierarchy values recompiles. With ctx, the program is small
    # and reusable across hierarchies of the same shape.
    if ctx is not None:
        _mv, _pc, _mvp = matvec, precond, matvec_precond
        matvec = lambda v: _mv(ctx, v)
        precond = lambda v: _pc(ctx, v)
        matvec_precond = (None if _mvp is None
                          else (lambda v: _mvp(ctx, v)))
    B, n = b.re.shape
    m = restart
    rdtype = b.re.dtype
    eps = jnp.finfo(rdtype).tiny

    # Stagnation cutoff: a restart cycle in which no active row improves by
    # more than (1 - stall_ratio) means the attainable (finite-precision)
    # floor was likely hit -- further restarts only burn V-cycles: in f32,
    # solves below the eps*kappa floor otherwise spend max_restarts at
    # ~3e-4. Restarted GMRES on the indefinite
    # Schwinger operator can plateau for one cycle and then converge, so
    # termination requires ``stall_cycles`` CONSECUTIVE stalled cycles, and
    # the per-row ``stalled`` flag in the result reports any row whose final
    # residual is still above tol_abs. stall_ratio=None disables the cutoff
    # (exact-parity runs).

    def cycle_body(state):
        x, resnorm, prev, iters, cycles, stalls = state
        r = b - matvec(x)
        beta = pnorm(r, axis_name)
        V = cplx.czeros((m + 1, B, n), rdtype)
        V = _cp_set(V, 0, cplx.scale_real(r, 1.0 / jnp.maximum(beta, eps)[:, None]))
        Z = cplx.czeros((m, B, n), rdtype)
        H = cplx.czeros((B, m + 1, m), rdtype)
        g = cplx.czeros((B, m + 1), rdtype)
        g = _cp_set(g, (slice(None), 0), CP(beta, jnp.zeros_like(beta)))
        cs = jnp.zeros((m, B), rdtype)
        sn = cplx.czeros((m, B), rdtype)
        res = beta

        def arnoldi_cond(c):
            V, Z, H, g, cs, sn, j, res, iters = c
            unconv = _gany(jnp.any(res > tol_abs), pred_axis_names)
            return jnp.logical_and(j < m, unconv)

        def arnoldi_body(c):
            V, Z, H, g, cs, sn, j, res, iters = c
            active = res > tol_abs
            iters = iters + active.astype(jnp.int32)
            vj = V[j]
            if matvec_precond is not None:
                # fused preconditioner+operator: the V-cycle's own final
                # residual gives A z = v - r, saving the outer stencil matvec
                # per Arnoldi step (mg/cycle.py precond_matvec)
                z, w = matvec_precond(vj)
            else:
                z = precond(vj)
                w = matvec(z)
            Z = _cp_set(Z, j, z)

            hcol = cplx.czeros((B, m + 1), rdtype)

            def mgs(i, wh):
                w, hcol = wh
                hi = pdot(V[i], w, axis_name)             # (B,)
                w = w - cplx.cmul(_bc(hi), V[i])
                return (w, _cp_set(hcol, (slice(None), i), hi))

            w, hcol = lax.fori_loop(0, j + 1, mgs, (w, hcol))
            hnorm = pnorm(w, axis_name)
            hcol = _cp_set(
                hcol, (slice(None), j + 1), CP(hnorm, jnp.zeros_like(hnorm))
            )
            V = _cp_set(
                V, j + 1, cplx.scale_real(w, 1.0 / jnp.maximum(hnorm, eps)[:, None])
            )

            def rot(i, hcol):
                hi, hip1 = _rot_apply(
                    cs[i], sn[i], hcol[:, i], hcol[:, i + 1]
                )
                hcol = _cp_set(hcol, (slice(None), i), hi)
                return _cp_set(hcol, (slice(None), i + 1), hip1)

            hcol = lax.fori_loop(0, j, rot, hcol)
            c_new, s_new, r_new = _givens(hcol[:, j], hcol[:, j + 1])
            zero = CP(jnp.zeros((B,), rdtype), jnp.zeros((B,), rdtype))
            hcol = _cp_set(hcol, (slice(None), j), r_new)
            hcol = _cp_set(hcol, (slice(None), j + 1), zero)
            cs = cs.at[j].set(c_new)
            sn = _cp_set(sn, j, s_new)
            gj = g[:, j]
            g = _cp_set(g, (slice(None), j), CP(c_new * gj.re, c_new * gj.im))
            g = _cp_set(
                g, (slice(None), j + 1), -cplx.cmul(s_new.conj(), gj)
            )
            H = _cp_set(H, (slice(None), slice(None), j), hcol)
            res = jnp.where(active, cplx.cabs(g[:, j + 1]), res)
            return (V, Z, H, g, cs, sn, j + 1, res, iters)

        init = (V, Z, H, g, cs, sn, jnp.int32(0), res, iters)
        V, Z, H, g, cs, sn, j_fin, res, iters = lax.while_loop(
            arnoldi_cond, arnoldi_body, init
        )

        # back substitution on the rotated upper-triangular system; unused
        # columns (>= j_fin) carry identity diagonal + zero rhs -> y = 0
        diag_idx = jnp.arange(m)
        used = diag_idx < j_fin
        R = H[:, :m, :m]
        Rdiag = R[:, diag_idx, diag_idx]
        one = CP(jnp.ones_like(Rdiag.re), jnp.zeros_like(Rdiag.im))
        Rdiag = cplx.where(used[None, :], Rdiag, one)
        R = _cp_set(R, (slice(None), diag_idx, diag_idx), Rdiag)
        rhs = cplx.where(used[None, :], g[:, :m], cplx.czeros((B, m), rdtype))

        def back_sub(idx, y):
            j = m - 1 - idx
            Rrow = R[:, j, :]                       # (B, m)
            prod = cplx.cmul(Rrow, y)               # elementwise
            s_re = rhs.re[:, j] - jnp.sum(prod.re, axis=-1)
            s_im = rhs.im[:, j] - jnp.sum(prod.im, axis=-1)
            yj = cplx.cdiv(CP(s_re, s_im), R[:, j, j], eps=eps)
            return _cp_set(y, (slice(None), j), yj)

        y = lax.fori_loop(0, m, back_sub, cplx.czeros((B, m), rdtype))
        x = x + cplx.einsum2("jbn,bj->bn", Z, y)
        # Termination decisions use the TRUE residual, never the Givens
        # estimate: in f32 with a near-exact preconditioner (coarse MG
        # levels) the estimate collapses below tol within a few Arnoldi
        # steps while the true residual plateaus 10-100x higher (level-2
        # solves were seen to exit at estimate 5e-4 with true relres ~1e-2). One extra matvec per restart cycle (~2% of a
        # 40-step cycle) buys an honest exit; it also replaces the final
        # residual recomputation after the loop.
        true_res = pnorm(b - matvec(x), axis_name)
        if stall_ratio is None:
            stalls = jnp.int32(0)
        else:
            # progress check on the still-active rows only (already-converged
            # rows must not count as progress: their prev is zeroed out)
            active_prev = jnp.where(resnorm > tol_abs, resnorm, 0.0)
            progressing = _gany(
                jnp.any(true_res < stall_ratio * active_prev), pred_axis_names
            )
            stalls = jnp.where(progressing, jnp.int32(0), stalls + 1)
        return (x, true_res, resnorm, iters, cycles + 1, stalls)

    def cycle_cond(state):
        x, resnorm, prev, iters, cycles, stalls = state
        unconverged = _gany(jnp.any(resnorm > tol_abs), pred_axis_names)
        ok = jnp.logical_and(cycles < max_restarts, unconverged)
        return jnp.logical_and(ok, stalls < stall_cycles)

    x0_res = pnorm(b - matvec(x0), axis_name)
    state = (x0, x0_res, jnp.full_like(x0_res, jnp.inf),
             jnp.zeros((B,), jnp.int32), jnp.int32(0), jnp.int32(0))
    x, final_res, _, iters, cycles, _ = lax.while_loop(
        cycle_cond, cycle_body, state
    )
    return x, final_res, iters, cycles


def fgmres(
    matvec: Callable[[CP], CP],
    b: CP,
    *,
    tol: float,
    restart: int = 20,
    max_restarts: int = 10,
    precond: Optional[Callable[[CP], CP]] = None,
    matvec_precond: Optional[Callable] = None,
    x0: Optional[CP] = None,
    stall_ratio: Optional[float] = 0.9,
    stall_cycles: int = 2,
    axis_name: Optional[str] = None,
    pred_axis_names: tuple = (),
    ctx=None,
) -> FGMRESResult:
    """Solve A x = b for a batch of pair right-hand sides b (B, n).

    ``matvec_precond``: optional fused v -> (z, A z) (z = M v); when given it
    replaces the per-Arnoldi-step precond+matvec pair (restart-boundary true
    residuals still use ``matvec``). Algebraically identical.

    ``stall_ratio``/``stall_cycles``: terminate after ``stall_cycles``
    consecutive restart cycles in which no active row improved by more than
    (1 - stall_ratio); ``stall_ratio=None`` disables the cutoff. Rows whose
    final residual is above tol are flagged in ``result.stalled``.

    ``axis_name``: set when running INSIDE shard_map with the vector axis
    lattice-sharded over that mesh axis -- all inner products and norms then
    psum their shard-local partial sums (parallel/sharded_solve.py).

    ``pred_axis_names``: mesh axes over which the loop-termination predicates
    are globalized (any-reduce). MUST cover every mesh axis whose shards run
    collectives inside this solve but hold different rows (the 'samples'
    axis): otherwise early-converging shards stop issuing the halo collective
    and the ring deadlocks. Matches single-chip batched semantics (all rows
    step until the slowest converges) at the cost of one scalar psum."""
    single = b.re.ndim == 1
    if single:
        b = CP(b.re[None, :], b.im[None, :])
    if x0 is None:
        x0 = cplx.czeros(b.re.shape, b.re.dtype)
    elif single:
        x0 = CP(x0.re[None, :], x0.im[None, :])
    if precond is None:
        precond = _identity_pc_ctx if ctx is not None else _identity_pc
    bnorm = pnorm(b, axis_name)
    tol_abs = jnp.asarray(tol, bnorm.dtype) * bnorm
    x, res, iters, cycles = _fgmres_impl(
        matvec, precond, b, x0, tol_abs, int(restart), int(max_restarts),
        None if stall_ratio is None else float(stall_ratio), int(stall_cycles),
        axis_name, tuple(pred_axis_names), matvec_precond=matvec_precond,
        ctx=ctx,
    )
    stalled = res > tol_abs
    if single:
        x, res, bnorm, iters = x[0], res[0], bnorm[0], iters[0]
        stalled = stalled[0]
    return FGMRESResult(x=x, resnorm=res, bnorm=bnorm, iters=iters,
                        cycles=cycles, stalled=stalled)


def _identity_pc(v):
    return v


def _identity_pc_ctx(ctx, v):
    return v


def wrap_complex_matvec(mv: Callable) -> Callable[[CP], CP]:
    """Adapt a complex-array matvec (host/test oracle) to the pair interface.

    Round-trips through host numpy -- validation convenience only, never the
    production path.
    """

    def pmv(v: CP) -> CP:
        z = mv(jnp.asarray(cplx.to_complex(v)))
        return cplx.from_complex(z)

    return pmv


def fgmres_complex(matvec, b, **kw) -> FGMRESResult:
    """Complex-array convenience wrapper (tests and host oracles)."""
    res = fgmres(wrap_complex_matvec(matvec), cplx.from_complex(b), **kw)
    return res
