"""Single-pass pair-stencil kernels for the GPU (Pallas, Triton route).

XLA's fusion of the rolled-read pair stencil (ops/dirac.py) moves several
times the bytes the operator needs. These kernels read each input once per
site (the four neighbour reads of a tile hit L1/L2), read the coefficients
of their tile, and write each output once:

  * ``stencil_apply``:      y = A v
  * ``poly_root_update``:   one root of the GMRES-polynomial smoother,
                            x <- x + cur/theta,  cur <- cur - A cur/theta
                            (A is linear, so A(cur/theta) = (A cur)/theta).

Layout: the (B, 2, X, T) pair grids are passed flat; one program handles one
probe row and ``bx`` consecutive x-rows (all of T), gathering the periodic
neighbours with flat index arithmetic. ``interpret=True`` runs the same
kernel on the CPU (tests/test_stencil_kernel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.dirac import TAPS

TILE = 1024          # sites per program (bx * nt)


def block_rows(nx: int, nt: int, tile: int = TILE) -> int:
    """x-rows per program (``tile`` sites, at least one row); 0 when the
    lattice does not split into whole blocks of at most 4 * tile sites
    (the caller then keeps XLA)."""
    bx = max(1, tile // nt)
    return bx if nx % bx == 0 and bx * nt <= 4 * tile else 0


# The kernels are chosen on the GPU whenever the lattice splits into whole
# blocks; False while a mesh run is traced (plain_under_mesh).
ENABLED = True


def plain_under_mesh(estimator):
    """Run ``estimator(..., mesh=m)`` with the kernels off when a mesh is
    given: GSPMD cannot partition a Pallas call, so mesh runs keep XLA's
    stencil (the lattice-sharded solve has its own halo stencil)."""

    @functools.wraps(estimator)
    def run(*args, mesh=None, **kwargs):
        global ENABLED
        if mesh is None:
            return estimator(*args, **kwargs)
        saved, ENABLED = ENABLED, False
        try:
            return estimator(*args, mesh=mesh, **kwargs)
        finally:
            ENABLED = saved

    return run


def use_kernel(nx: int, nt: int, backend: str | None = None) -> bool:
    """Whether PairStencilOperator.matvec and the poly smoother take the
    kernels: on the GPU backend, for lattices that split into blocks."""
    backend = backend or jax.default_backend()
    return ENABLED and backend == "gpu" and block_rows(nx, nt) > 0


def _wrap(i, n):
    return jnp.where(i < 0, i + n, jnp.where(i >= n, i - n, i))


def _apply_tile(cr_ref, ci_ref, vr_ref, vi_ref, b, site, x, t, nx, nt):
    """(A v) on one tile of sites: returns [re, im] accumulators per out-spin."""
    plane = nx * nt
    acc_r = [None, None]
    acc_i = [None, None]
    for k, (dx, dt) in enumerate(TAPS):
        nsite = _wrap(x + dx, nx) * nt + _wrap(t + dt, nt)
        for s in (0, 1):
            vidx = (b * 2 + s) * plane + nsite
            vr = pltr.load(vr_ref.at[vidx])
            vi = pltr.load(vi_ref.at[vidx])
            for a in (0, 1):
                if a != s and k == 0:
                    continue          # cross-spin on-site tap is structurally 0
                cidx = ((a * 2 + s) * 5 + k) * plane + site
                cr = pltr.load(cr_ref.at[cidx])
                ci = pltr.load(ci_ref.at[cidx])
                re = cr * vr - ci * vi
                im = cr * vi + ci * vr
                acc_r[a] = re if acc_r[a] is None else acc_r[a] + re
                acc_i[a] = im if acc_i[a] is None else acc_i[a] + im
    return acc_r, acc_i


def _tile_coords(nx, nt, bx):
    b = pl.program_id(0)
    loc = jnp.arange(bx * nt, dtype=jnp.int32)
    x = pl.program_id(1) * bx + loc // nt
    t = loc % nt
    return b, x * nt + t, x, t


def _stencil_body(cr_ref, ci_ref, vr_ref, vi_ref, yr_ref, yi_ref, *, nx, nt, bx):
    b, site, x, t = _tile_coords(nx, nt, bx)
    acc_r, acc_i = _apply_tile(cr_ref, ci_ref, vr_ref, vi_ref, b, site, x, t, nx, nt)
    for a in (0, 1):
        oidx = (b * 2 + a) * nx * nt + site
        pltr.store(yr_ref.at[oidx], acc_r[a])
        pltr.store(yi_ref.at[oidx], acc_i[a])


def _root_body(cr_ref, ci_ref, inv_ref, ur_ref, ui_ref, xr_ref, xi_ref,
               xr_out, xi_out, ur_out, ui_out, *, nx, nt, bx, first):
    b, site, x, t = _tile_coords(nx, nt, bx)
    acc_r, acc_i = _apply_tile(cr_ref, ci_ref, ur_ref, ui_ref, b, site, x, t, nx, nt)
    ir = pltr.load(inv_ref.at[0])
    ii = pltr.load(inv_ref.at[1])
    for a in (0, 1):
        idx = (b * 2 + a) * nx * nt + site
        ur = pltr.load(ur_ref.at[idx])
        ui = pltr.load(ui_ref.at[idx])
        sr = ir * ur - ii * ui              # step = cur / theta
        si = ir * ui + ii * ur
        if not first:
            sr = sr + pltr.load(xr_ref.at[idx])
            si = si + pltr.load(xi_ref.at[idx])
        pltr.store(xr_out.at[idx], sr)
        pltr.store(xi_out.at[idx], si)
        # cur - (A cur) / theta
        pltr.store(ur_out.at[idx], ur - (ir * acc_r[a] - ii * acc_i[a]))
        pltr.store(ui_out.at[idx], ui - (ir * acc_i[a] + ii * acc_r[a]))


def _flat(a):
    return a.reshape(-1)


def _call(body, n_out, coeffs: CP, batch, nx, nt, tile, interpret, *args):
    bx = block_rows(nx, nt, tile)
    out = jax.ShapeDtypeStruct((batch * 2 * nx * nt,), coeffs.re.dtype)
    return pl.pallas_call(
        functools.partial(body, nx=nx, nt=nt, bx=bx),
        out_shape=(out,) * n_out,
        grid=(batch, nx // bx),
        interpret=interpret,
        compiler_params=pltr.CompilerParams(num_warps=4, num_stages=1),
        name=body.__name__.strip("_"),
    )(_flat(coeffs.re), _flat(coeffs.im), *args)


def stencil_apply(coeffs: CP, v: CP, nx: int, nt: int, tile: int = TILE,
                  interpret: bool = False) -> CP:
    """y = A v for flat pair vectors v (..., 2*nx*nt)."""
    shape = v.re.shape
    batch = max(1, int(jnp.size(v.re)) // (2 * nx * nt))
    yr, yi = _call(_stencil_body, 2, coeffs, batch, nx, nt, tile, interpret,
                   _flat(v.re), _flat(v.im))
    return CP(yr.reshape(shape), yi.reshape(shape))


def poly_root_update(coeffs: CP, cur: CP, x, inv_root: complex, nx: int,
                     nt: int, tile: int = TILE, interpret: bool = False):
    """One smoother root: (x + cur/theta, cur - A cur/theta), with
    ``inv_root`` = 1/theta and x None for the first root."""
    shape = cur.re.shape
    batch = max(1, int(jnp.size(cur.re)) // (2 * nx * nt))
    inv = jnp.asarray([inv_root.real, inv_root.imag], cur.re.dtype)
    first = x is None
    xr, xi = (cur.re, cur.im) if first else (x.re, x.im)
    body = functools.partial(_root_body, first=first)
    body.__name__ = "_poly_root_update"
    outs = _call(body, 4, coeffs, batch, nx, nt, tile, interpret,
                 inv, _flat(cur.re), _flat(cur.im), _flat(xr), _flat(xi))
    xr, xi, ur, ui = (o.reshape(shape) for o in outs)
    return CP(xr, xi), CP(ur, ui)
