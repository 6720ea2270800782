"""Precision contract of the pair contraction helpers (ops/cplx.py).

Every device product that feeds an estimate goes through matmul_right,
matmul_right_conjT, einsum2 or einsum2_conj_a, which pin
precision=HIGHEST. These tests hold float32 results to float64 NumPy at
1e-6 (max|err| / max|ref|) -- a bound float32 round-off meets and TF32
(operands rounded to a 10-bit mantissa, as a default-precision float32
matmul may run on the GPU) does not, which the last test demonstrates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.ops import cplx

TOL = 1e-6


def _pair(rng, shape):
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return z.astype(np.complex128), cplx.CP(jnp.asarray(z.real), jnp.asarray(z.imag))


def _rel(got: cplx.CP, want: np.ndarray) -> float:
    g = cplx.to_complex(got).astype(np.complex128)
    return float(np.max(np.abs(g - want)) / np.max(np.abs(want)))


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round float32 values to TF32's 10-bit mantissa (truncation)."""
    bits = np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def test_matmul_right_float32_matches_float64():
    rng = np.random.default_rng(0)
    a64, a = _pair(rng, (64, 64))
    x64, x = _pair(rng, (8, 64))
    y = jax.jit(cplx.matmul_right)(x, a)
    assert y.re.dtype == jnp.float32
    assert _rel(y, x64 @ a64.T) < TOL


def test_matmul_right_conjT_float32_matches_float64():
    rng = np.random.default_rng(1)
    u64, u = _pair(rng, (64, 12))
    x64, x = _pair(rng, (8, 64))
    assert _rel(jax.jit(cplx.matmul_right_conjT)(x, u), x64 @ np.conj(u64)) < TOL


@pytest.mark.parametrize("conj_a", [False, True])
def test_einsum2_float32_matches_float64(conj_a):
    rng = np.random.default_rng(2)
    p64, p = _pair(rng, (16, 32, 8))          # (n_aggr, L, dc) prolongator blocks
    y64, y = _pair(rng, (4, 16, 32))
    if conj_a:
        got = cplx.einsum2_conj_a("alk,...al->...ak", p, y)
        want = np.einsum("alk,...al->...ak", np.conj(p64), y64)
    else:
        y64, y = _pair(rng, (4, 16, 8))
        got = cplx.einsum2("alk,...ak->...al", p, y)
        want = np.einsum("alk,...ak->...al", p64, y64)
    assert _rel(got, want) < TOL


def test_tf32_operands_fail_the_bound():
    """The 1e-6 bound above detects TF32: the same product with operands
    rounded to TF32 misses it by orders of magnitude."""
    rng = np.random.default_rng(0)
    a64, _ = _pair(rng, (64, 64))
    x64, _ = _pair(rng, (8, 64))
    a_t = _tf32(a64.real) + 1j * _tf32(a64.imag)
    x_t = _tf32(x64.real) + 1j * _tf32(x64.imag)
    want = x64 @ a64.T
    err = np.max(np.abs(x_t.astype(np.complex128) @ a_t.astype(np.complex128).T - want))
    assert err / np.max(np.abs(want)) > 100 * TOL
