"""The Wilson--Dirac 9-point stencil operator as dense coefficient fields.

The reference stores D as a scipy CSR matrix and multiplies with native SpMV
(reference: multigrid.py:552-557 and every ``A*x`` site). Every nonzero of the
Schwinger matrices lies on one of 9 lattice offsets per row -- diagonal + 4
same-spin nearest neighbors + 4 opposite-spin nearest neighbors, with periodic
wrap (verified empirically for both shipped .mat files; see
io/stencil.py). The device representation is therefore a dense complex
coefficient tensor

    C[s_out, s_in, tap, x, t]     shape (2, 2, 5, X, T)

with taps ((dx, dt)) = ((0,0), (0,1), (0,-1), (1,0), (-1,0)); the cross-spin
diagonal tap is structurally zero. The matvec is 5 rolled reads fused with a
(2x2 spin) contraction -- elementwise work that XLA fuses into a handful of
kernels, batched over any number of probe vectors at once.

Vector layout matches the reference's spin-major flat indexing
(index = spin*(N/2) + x*nt + t, reference: gateway.py:159, multigrid.py:144-149):
flat vectors of length N = 2*X*T reshape to (..., 2, X, T) with C order.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

from deflatedmlmc_schwinger_tpu.ops.pytree import pytree_dataclass, static_field

# (dx, dt) offsets; tap 0 is the on-site term.
TAPS: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))


@pytree_dataclass
class StencilOperator:
    """9-point gauged stencil on the (spin=2, X, T) lattice.

    ``coeffs`` has shape (2, 2, 5, X, T): out-spin, in-spin, tap, x, t.
    """

    coeffs: jnp.ndarray
    nx: int = static_field(0)
    nt: int = static_field(0)

    @property
    def n(self) -> int:
        return 2 * self.nx * self.nt

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        """Apply to flat vectors v of shape (..., N)."""
        return stencil_matvec(self.coeffs, v, self.nx, self.nt)

    def to_grid(self, v: jnp.ndarray) -> jnp.ndarray:
        return v.reshape(v.shape[:-1] + (2, self.nx, self.nt))

    def from_grid(self, g: jnp.ndarray) -> jnp.ndarray:
        return g.reshape(g.shape[:-3] + (2 * self.nx * self.nt,))


def stencil_matvec(coeffs: jnp.ndarray, v: jnp.ndarray, nx: int, nt: int) -> jnp.ndarray:
    """y = D @ v for flat v of shape (..., 2*nx*nt).

    y[s,x,t] = sum_{s',k} C[s,s',k,x,t] * v[s', (x+dx_k)%nx, (t+dt_k)%nt].
    """
    batch_shape = v.shape[:-1]
    g = v.reshape(batch_shape + (2, nx, nt))
    out = jnp.zeros_like(g)
    for k, (dx, dt) in enumerate(TAPS):
        shifted = g
        if dx:
            shifted = jnp.roll(shifted, shift=-dx, axis=-2)
        if dt:
            shifted = jnp.roll(shifted, shift=-dt, axis=-1)
        # out[..., s, x, t] += sum_{s'} C[s, s', k, x, t] * shifted[..., s', x, t]
        out = out + jnp.einsum("abxt,...bxt->...axt", coeffs[:, :, k], shifted,
                               precision=lax.Precision.HIGHEST)
    return out.reshape(v.shape)


def gamma3_matvec_ctx(op, v):
    """Q = gamma3 A as a ctx-style pair matvec: module-level so the jitted
    eigensolver kernels (solvers/eigs.py lru-cached factories) key on ONE
    stable callable and the operator rides as a jit argument."""
    return gamma3_pair(op.matvec(v))


def stencil_matvec_host(coeffs, v, nx: int, nt: int):
    """Host (numpy, caller-chosen precision) twin of ``stencil_matvec``.

    Used to compute EXACT f64 residuals of f32 device solves for iterative
    refinement of the deflation-correction solves (trace/deflation.py):
    ``coeffs`` is the complex (2, 2, 5, X, T) array, ``v`` a complex
    (..., N) batch."""
    import numpy as np

    batch_shape = v.shape[:-1]
    g = v.reshape(batch_shape + (2, nx, nt))
    out = np.zeros_like(g)
    for k, (dx, dt) in enumerate(TAPS):
        shifted = g
        if dx:
            shifted = np.roll(shifted, -dx, axis=-2)
        if dt:
            shifted = np.roll(shifted, -dt, axis=-1)
        out = out + np.einsum("abxt,...bxt->...axt", coeffs[:, :, k], shifted)
    return out.reshape(v.shape)


@pytree_dataclass
class PairStencilOperator:
    """Device form of the stencil operator on (re, im) pairs.

    The spin contraction is unrolled into elementwise multiply-adds (20 real
    FMA fields per output component) -- no complex dtype, no dot_general:
    XLA fuses the whole apply into elementwise kernels.
    """

    coeffs: "CP"  # pair of (2, 2, 5, X, T) real arrays
    nx: int = static_field(0)
    nt: int = static_field(0)

    @property
    def n(self) -> int:
        return 2 * self.nx * self.nt

    @property
    def dtype(self):
        return self.coeffs.re.dtype

    def matvec(self, v: "CP") -> "CP":
        """Apply to flat pair vectors v of shape (..., N): the single-pass
        kernel on the GPU (ops/stencil_kernel.py), XLA elsewhere."""
        from deflatedmlmc_schwinger_tpu.ops import stencil_kernel

        if stencil_kernel.use_kernel(self.nx, self.nt):
            return stencil_kernel.stencil_apply(self.coeffs, v, self.nx, self.nt)
        return pair_stencil_xla(self.coeffs, v, self.nx, self.nt)


def pair_stencil_xla(coeffs, v, nx: int, nt: int):
    """The pair stencil in plain jax.numpy (5 rolled reads, 18 complex
    multiply-adds per site), fused by XLA; the reference for the kernel."""
    from deflatedmlmc_schwinger_tpu.ops import cplx

    batch = v.re.shape[:-1]
    gr = v.re.reshape(batch + (2, nx, nt))
    gi = v.im.reshape(batch + (2, nx, nt))
    out_r = [0.0, 0.0]
    out_i = [0.0, 0.0]
    for k, (dx, dt) in enumerate(TAPS):
        sr, si = gr, gi
        if dx:
            sr = jnp.roll(sr, shift=-dx, axis=-2)
            si = jnp.roll(si, shift=-dx, axis=-2)
        if dt:
            sr = jnp.roll(sr, shift=-dt, axis=-1)
            si = jnp.roll(si, shift=-dt, axis=-1)
        for a in range(2):
            for b in range(2):
                if a != b and k == 0:
                    continue  # cross-spin diagonal structurally zero
                cr = coeffs.re[a, b, k]
                ci = coeffs.im[a, b, k]
                vr = sr[..., b, :, :]
                vi = si[..., b, :, :]
                out_r[a] = out_r[a] + (cr * vr - ci * vi)
                out_i[a] = out_i[a] + (cr * vi + ci * vr)
    yr = jnp.stack(out_r, axis=-3).reshape(v.re.shape)
    yi = jnp.stack(out_i, axis=-3).reshape(v.im.shape)
    return cplx.CP(yr, yi)


def pair_operator(op: StencilOperator) -> PairStencilOperator:
    """Host-side conversion StencilOperator -> PairStencilOperator."""
    import numpy as np

    from deflatedmlmc_schwinger_tpu.ops import cplx

    C = np.asarray(op.coeffs)
    return PairStencilOperator(
        coeffs=cplx.CP(
            jnp.asarray(np.ascontiguousarray(C.real)),
            jnp.asarray(np.ascontiguousarray(C.imag)),
        ),
        nx=op.nx,
        nt=op.nt,
    )


def gamma3_pair(v):
    """gamma3 on flat pair vectors (negate the second spin half)."""
    from deflatedmlmc_schwinger_tpu.ops.cplx import CP

    half = v.re.shape[-1] // 2
    return CP(
        jnp.concatenate([v.re[..., :half], -v.re[..., half:]], axis=-1),
        jnp.concatenate([v.im[..., :half], -v.im[..., half:]], axis=-1),
    )


def shift_rows_up_pair(v, d: int):
    from deflatedmlmc_schwinger_tpu.ops.cplx import CP

    return CP(jnp.roll(v.re, -d, axis=-1), jnp.roll(v.im, -d, axis=-1))


def shift_rows_down_pair(v, d: int):
    from deflatedmlmc_schwinger_tpu.ops.cplx import CP

    return CP(jnp.roll(v.re, d, axis=-1), jnp.roll(v.im, d, axis=-1))


def gamma3(v: jnp.ndarray) -> jnp.ndarray:
    """Apply gamma_3 = diag(+I, -I) on the two spin halves of flat vectors.

    Reference: multigrid.py:130-133 builds this diag at every level; here it is
    an index-free sign flip of the second half (valid at every level because
    aggregates never straddle the spin boundary -- see mg/setup.py).
    """
    half = v.shape[-1] // 2
    return jnp.concatenate([v[..., :half], -v[..., half:]], axis=-1)


def shift_rows_up(v: jnp.ndarray, d: int) -> jnp.ndarray:
    """(Pi v)[i] = v[(i+d) % N] -- the reference's Pperm "rows upwards"
    cyclic displacement operator (multigrid.py:141-155)."""
    return jnp.roll(v, shift=-d, axis=-1)


def shift_rows_down(v: jnp.ndarray, d: int) -> jnp.ndarray:
    """(Pi^T v)[i] = v[(i-d) % N] (reference: utils.py:232 ``Pperm.transpose()*x``)."""
    return jnp.roll(v, shift=d, axis=-1)
