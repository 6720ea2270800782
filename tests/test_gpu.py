"""Device numerics on the GPU: the XLA pair stencil and the depth-16 poly
smoother in float32 against their float64 host twins, and the coarsest
apply's matmul under the precision pin. Skipped without a card (the ``gpu``
fixture decides); run on the card in one process:

    JAX_PLATFORMS=cuda python -m pytest -p no:xdist -m gpu tests/
"""

import jax
import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu import oracles
from deflatedmlmc_schwinger_tpu.io import load_operator
from deflatedmlmc_schwinger_tpu.mg.cycle import gmres_poly_roots, poly_smoother
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator, stencil_matvec_host

TOL = 1e-5


def _setup(device, batch, seed):
    op, _ = load_operator(oracles.SPEC128, oracles.MASS128, dtype=np.complex64)
    pop = jax.device_put(pair_operator(op), device)
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((batch, op.n))
         + 1j * rng.standard_normal((batch, op.n))).astype(np.complex64)
    C = np.asarray(op.coeffs).astype(np.complex128)
    return op, pop, C, z, jax.device_put(cplx.from_complex(z), device)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.gpu
def test_stencil_matches_host_twin(gpu):
    op, pop, C, z, v = _setup(gpu, 32, 0)
    y = cplx.to_complex(jax.jit(pop.matvec)(v))
    want = stencil_matvec_host(C, z.astype(np.complex128), op.nx, op.nt)
    assert _rel(y, want) < TOL


@pytest.mark.gpu
def test_poly_smoother_matches_host_recurrence(gpu):
    op, pop, C, z, v = _setup(gpu, 16, 1)
    roots = gmres_poly_roots(jax.jit(pop.matvec), op.n, pop.dtype, 16)
    x = cplx.to_complex(jax.jit(lambda r: poly_smoother(pop.matvec, r, roots))(v))
    xh, cur = 0.0, z.astype(np.complex128)
    for k, th in enumerate(roots):
        step = cur / th
        xh = xh + step
        if k < len(roots) - 1:
            cur = cur - stencil_matvec_host(C, step, op.nx, op.nt)
    assert _rel(x, xh) < TOL


@pytest.mark.gpu
def test_coarsest_matmul_is_not_tf32(gpu):
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((512, 512)) + 1j * rng.standard_normal((512, 512))).astype(np.complex64)
    x = (rng.standard_normal((64, 512)) + 1j * rng.standard_normal((64, 512))).astype(np.complex64)
    y = jax.jit(cplx.matmul_right)(jax.device_put(cplx.from_complex(x), gpu),
                                   jax.device_put(cplx.from_complex(a), gpu))
    want = x.astype(np.complex128) @ a.astype(np.complex128).T
    assert _rel(cplx.to_complex(y), want) < TOL


@pytest.mark.gpu
def test_compiled_kernels_match_xla(gpu):
    from deflatedmlmc_schwinger_tpu.mg.cycle import _poly_smoother_kernel
    from deflatedmlmc_schwinger_tpu.ops.dirac import pair_stencil_xla
    from deflatedmlmc_schwinger_tpu.ops.stencil_kernel import stencil_apply

    op, pop, C, z, v = _setup(gpu, 16, 3)

    def xla(w):
        return pair_stencil_xla(pop.coeffs, w, op.nx, op.nt)

    got = cplx.to_complex(jax.jit(lambda w: stencil_apply(pop.coeffs, w, op.nx, op.nt))(v))
    assert _rel(got, cplx.to_complex(jax.jit(xla)(v))) < TOL
    roots = gmres_poly_roots(jax.jit(xla), op.n, pop.dtype, 16)
    xk, ck = jax.jit(lambda w: _poly_smoother_kernel(pop, w, roots, True))(v)
    xx, cx = jax.jit(lambda w: poly_smoother(xla, w, roots, with_residual=True))(v)
    assert _rel(cplx.to_complex(xk), cplx.to_complex(xx)) < TOL
    assert _rel(cplx.to_complex(ck), cplx.to_complex(cx)) < TOL
