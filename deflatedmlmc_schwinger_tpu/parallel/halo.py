"""Explicit halo-exchange stencil matvec over a lattice-sharded mesh axis
(SURVEY.md P3: the domain-decomposition axis, the reference's CSR SpMV
- multigrid.py:552-557 - scaled past one chip).

Two ways to run the 9-point stencil on an 'x'-sharded lattice:

  1. the implicit path (parallel/mesh.py + ops/dirac.py): shard the grid
     fields and let GSPMD turn ``jnp.roll`` into collective-permutes;
  2. this module: ``shard_map`` with a hand-written halo exchange --
     each shard sends exactly ONE boundary row per direction per apply
     (``lax.ppermute`` ring in x), computes its interior locally, and never
     materializes a full shifted copy. This is the form whose communication
     volume is the provable minimum (one (B, 2, T) row per neighbor) and the
     shape a multi-chip production solve wants.

Only the x axis is sharded (taps reach +-1 in x); the t axis stays local per
shard, so t shifts are plain rolls. Aggregation boundaries (aggrs[0] >= 2
rows of x per aggregate) always contain whole shards for the production
shard counts, so P/R stay shard-local (SURVEY.md section 5.7).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.dirac import TAPS, PairStencilOperator


def shard_coeffs(pop: PairStencilOperator, mesh: Mesh, x_axis: str = "x"
                 ) -> PairStencilOperator:
    """Place the (2, 2, 5, X, T) coefficient pair with X sharded over
    ``x_axis`` (everything else replicated)."""
    spec = NamedSharding(mesh, P(None, None, None, x_axis, None))
    return pop.replace(
        coeffs=CP(
            jax.device_put(pop.coeffs.re, spec),
            jax.device_put(pop.coeffs.im, spec),
        )
    )


def _ring_perm(n: int, step: int):
    return [(i, (i + step) % n) for i in range(n)]


def _halo_kernel(cr, ci, vr, vi, *, x_axis: str, nshards: int):
    """Local stencil apply on one x-shard: v is (B, 2, nx_loc, nt); the +-1 x
    neighbors' boundary rows arrive via one ppermute each."""
    # receive next shard's FIRST row (for out rows needing v[x+1]) by sending
    # mine to the previous shard, and vice versa for v[x-1]
    first_r, first_i = vr[:, :, :1], vi[:, :, :1]
    last_r, last_i = vr[:, :, -1:], vi[:, :, -1:]
    if nshards > 1:
        down = _ring_perm(nshards, -1)   # shard s -> s-1 : s receives from s+1
        up = _ring_perm(nshards, +1)     # shard s -> s+1 : s receives from s-1
        nxt_r = lax.ppermute(first_r, x_axis, down)
        nxt_i = lax.ppermute(first_i, x_axis, down)
        prv_r = lax.ppermute(last_r, x_axis, up)
        prv_i = lax.ppermute(last_i, x_axis, up)
    else:
        nxt_r, nxt_i = first_r, first_i
        prv_r, prv_i = last_r, last_i

    def shifted(dx: int, dt: int):
        sr, si = vr, vi
        if dx == 1:      # needs v[x+1]: local rows 1.. + neighbor's first row
            sr = jnp.concatenate([vr[:, :, 1:], nxt_r], axis=2)
            si = jnp.concatenate([vi[:, :, 1:], nxt_i], axis=2)
        elif dx == -1:   # needs v[x-1]: neighbor's last row + local rows ..-1
            sr = jnp.concatenate([prv_r, vr[:, :, :-1]], axis=2)
            si = jnp.concatenate([prv_i, vi[:, :, :-1]], axis=2)
        if dt:
            sr = jnp.roll(sr, -dt, axis=-1)
            si = jnp.roll(si, -dt, axis=-1)
        return sr, si

    out_r = [0.0, 0.0]
    out_i = [0.0, 0.0]
    for k, (dx, dt) in enumerate(TAPS):
        sr, si = shifted(dx, dt)
        for a in range(2):
            for b in range(2):
                if a != b and k == 0:
                    continue  # cross-spin diagonal structurally zero
                c_r, c_i = cr[a, b, k], ci[a, b, k]      # (nx_loc, nt)
                v_r, v_i = sr[:, b], si[:, b]            # (B, nx_loc, nt)
                out_r[a] = out_r[a] + (c_r * v_r - c_i * v_i)
                out_i[a] = out_i[a] + (c_r * v_i + c_i * v_r)
    yr = jnp.stack(out_r, axis=1)
    yi = jnp.stack(out_i, axis=1)
    return yr, yi


def halo_matvec(
    pop: PairStencilOperator,
    mesh: Mesh,
    *,
    x_axis: str = "x",
    sample_axis: str = "samples",
) -> Callable[[CP], CP]:
    """Build a shard_map matvec over grid-form pair fields (B, 2, X, T) with
    B sharded over ``sample_axis`` and X over ``x_axis``.

    Returns f(v: CP grid (B, 2, X, T)) -> CP of the same shape/sharding.
    Coefficients must already be sharded (shard_coeffs). The per-apply
    communication is exactly two boundary rows per shard over the x ring.
    """
    nshards = mesh.shape[x_axis]
    if pop.nx % nshards:
        raise ValueError(f"nx={pop.nx} not divisible by {nshards} x-shards")
    vspec = P(sample_axis, None, x_axis, None)
    cspec = P(None, None, None, x_axis, None)
    kern = partial(_halo_kernel, x_axis=x_axis, nshards=nshards)
    f = jax.jit(
        jax.shard_map(
            kern,
            mesh=mesh,
            in_specs=(cspec, cspec, vspec, vspec),
            out_specs=(vspec, vspec),
        )
    )

    def matvec(v: CP) -> CP:
        yr, yi = f(pop.coeffs.re, pop.coeffs.im, v.re, v.im)
        return CP(yr, yi)

    return matvec
