"""Complex arithmetic on explicit (re, im) real pairs -- the device compute
representation.

The entire hot path -- stencil matvecs, Krylov solvers, V-cycles, deflation
projections -- runs on CP pairs of real arrays with explicit complex
arithmetic: elementwise ops and real matmuls only. (The design dates from a
backend that could not lower complex contractions inside XLA control flow;
whether native complex64 is faster on the GPU is an open question.)

Every real contraction here pins ``precision=HIGHEST``: the estimates
consume these products (coarsest inverse, deflation projector, P/R), and a
default-precision float32 matmul may run in TF32 on the GPU, which rounds
operands to a 10-bit mantissa.

Complex jnp arrays still appear OUTSIDE jitted control flow (setup-phase
QR/eigh/inv) and on the host/numpy edges.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

HIGHEST = lax.Precision.HIGHEST


class CP(NamedTuple):
    """A complex tensor as a pair of same-shaped real tensors."""

    re: jnp.ndarray
    im: jnp.ndarray

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def ndim(self):
        return self.re.ndim

    # -- linear ops (elementwise, loop-safe) --
    def __add__(self, o: "CP") -> "CP":
        return CP(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "CP") -> "CP":
        return CP(self.re - o.re, self.im - o.im)

    def __neg__(self) -> "CP":
        return CP(-self.re, -self.im)

    def __getitem__(self, idx) -> "CP":
        return CP(self.re[idx], self.im[idx])

    def reshape(self, *s) -> "CP":
        return CP(self.re.reshape(*s), self.im.reshape(*s))

    def astype(self, dt) -> "CP":
        return CP(self.re.astype(dt), self.im.astype(dt))

    @property
    def T(self) -> "CP":
        return CP(self.re.T, self.im.T)

    def conj(self) -> "CP":
        return CP(self.re, -self.im)


def real_dtype(cdtype) -> jnp.dtype:
    return jnp.zeros((), cdtype).real.dtype


def complex_dtype(rdtype) -> jnp.dtype:
    return jnp.dtype(jnp.complex128) if jnp.dtype(rdtype) == jnp.float64 else jnp.dtype(jnp.complex64)


def from_complex(z) -> CP:
    """Host/edge conversion (uses np to stay off unsupported device paths)."""
    z = np.asarray(z)
    return CP(jnp.asarray(np.ascontiguousarray(z.real)),
              jnp.asarray(np.ascontiguousarray(z.imag)))


def to_complex(p: CP) -> np.ndarray:
    return np.asarray(p.re) + 1j * np.asarray(p.im)


def czeros(shape, rdtype) -> CP:
    return CP(jnp.zeros(shape, rdtype), jnp.zeros(shape, rdtype))


def from_real(x: jnp.ndarray) -> CP:
    return CP(x, jnp.zeros_like(x))


def cmul(a: CP, b: CP) -> CP:
    """Elementwise (broadcasting) complex multiply."""
    return CP(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cmul_conj(a: CP, b: CP) -> CP:
    """conj(a) * b elementwise."""
    return CP(a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re)


def scale_real(a: CP, r) -> CP:
    return CP(a.re * r, a.im * r)


def cdiv(a: CP, b: CP, eps: float = 0.0) -> CP:
    d = b.re * b.re + b.im * b.im
    if eps:
        d = jnp.maximum(d, eps)
    return CP((a.re * b.re + a.im * b.im) / d, (a.im * b.re - a.re * b.im) / d)


def cabs2(a: CP) -> jnp.ndarray:
    return a.re * a.re + a.im * a.im


def cabs(a: CP) -> jnp.ndarray:
    return jnp.sqrt(cabs2(a))


def cdot(x: CP, y: CP, axis=-1) -> CP:
    """<x, y> = sum conj(x)*y along axis."""
    re = jnp.sum(x.re * y.re + x.im * y.im, axis=axis)
    im = jnp.sum(x.re * y.im - x.im * y.re, axis=axis)
    return CP(re, im)


def norm2(x: CP, axis=-1) -> jnp.ndarray:
    return jnp.sum(cabs2(x), axis=axis)


def norm(x: CP, axis=-1) -> jnp.ndarray:
    return jnp.sqrt(norm2(x, axis=axis))


def axpy(alpha: CP, x: CP, y: CP) -> CP:
    """y + alpha * x with alpha a CP scalar (or broadcastable)."""
    return CP(y.re + alpha.re * x.re - alpha.im * x.im,
              y.im + alpha.re * x.im + alpha.im * x.re)


def where(mask, a: CP, b: CP) -> CP:
    return CP(jnp.where(mask, a.re, b.re), jnp.where(mask, a.im, b.im))


def matmul_right(x: CP, A: CP) -> CP:
    """y = x @ A^T for batched row-vectors x (..., n) and matrix A (m, n):
    four real matmuls."""
    def mm(a, b):
        return jnp.matmul(a, b.T, precision=HIGHEST)

    return CP(mm(x.re, A.re) - mm(x.im, A.im), mm(x.re, A.im) + mm(x.im, A.re))


def matmul_right_conjT(x: CP, A: CP) -> CP:
    """y = x @ conj(A) (i.e. row-vectors times A^H transposed appropriately):
    used for projections c = x @ conj(U) with U (n, k)."""
    def mm(a, b):
        return jnp.matmul(a, b, precision=HIGHEST)

    return CP(mm(x.re, A.re) + mm(x.im, A.im), mm(x.im, A.re) - mm(x.re, A.im))


def einsum2(expr: str, a: CP, b: CP) -> CP:
    """Complex einsum as four real einsums."""
    rr, ii, ri, ir = _einsum4(expr, a, b)
    return CP(rr - ii, ri + ir)


def einsum2_conj_a(expr: str, a: CP, b: CP) -> CP:
    """Complex einsum with conj(a)."""
    rr, ii, ri, ir = _einsum4(expr, a, b)
    return CP(rr + ii, ri - ir)


def _einsum4(expr: str, a: CP, b: CP):
    def es(x, y):
        return jnp.einsum(expr, x, y, precision=HIGHEST)

    return es(a.re, b.re), es(a.im, b.im), es(a.re, b.im), es(a.im, b.re)
