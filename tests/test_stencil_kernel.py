"""The single-pass stencil kernels (ops/stencil_kernel.py) in Pallas
interpret mode against the plain XLA stencil and smoother, and the rule
that chooses them. The compiled kernels run in tests/test_gpu.py."""

import jax
import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.mg.cycle import _poly_smoother_kernel, poly_smoother
from deflatedmlmc_schwinger_tpu.ops import cplx, stencil_kernel
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator, pair_stencil_xla

TILE = 64   # 4 x-rows of the 16^2 lattice per program


@pytest.fixture(scope="module")
def pop16(op16):
    op, _ = op16
    return pair_operator(op)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return cplx.from_complex(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_stencil_apply_matches_xla(pop16, batch):
    v = _pair(batch + (pop16.n,), 0)
    got = stencil_kernel.stencil_apply(pop16.coeffs, v, 16, 16, tile=TILE,
                                       interpret=True)
    want = pair_stencil_xla(pop16.coeffs, v, 16, 16)
    assert got.re.shape == v.re.shape
    np.testing.assert_allclose(cplx.to_complex(got), cplx.to_complex(want),
                               atol=1e-12)


@pytest.mark.parametrize("with_residual", [False, True])
def test_poly_root_updates_match_poly_smoother(pop16, with_residual):
    roots = (2.0 + 0.5j, 3.0 - 1.0j, 1.5 + 0.2j, 4.0 + 0.0j)
    r = _pair((2, pop16.n), 1)
    got = _poly_smoother_kernel(pop16, r, roots, with_residual, tile=TILE,
                                interpret=True)
    want = poly_smoother(pop16.matvec, r, roots, with_residual=with_residual)
    if not with_residual:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(cplx.to_complex(g), cplx.to_complex(w),
                                   atol=1e-11)


def test_block_rows():
    assert stencil_kernel.block_rows(128, 128) == 8
    assert stencil_kernel.block_rows(512, 512) == 2
    assert stencil_kernel.block_rows(16, 16, tile=64) == 4
    assert stencil_kernel.block_rows(12, 128) == 0        # 12 % 8 != 0
    assert stencil_kernel.block_rows(4, 8192) == 0        # one row > 4 tiles


def test_kernel_chosen_only_on_gpu():
    assert stencil_kernel.use_kernel(128, 128, backend="gpu")
    assert not stencil_kernel.use_kernel(128, 128, backend="cpu")
    assert not stencil_kernel.use_kernel(12, 128, backend="gpu")
    assert not stencil_kernel.use_kernel(128, 128)        # this suite: cpu


def test_mesh_runs_keep_xla():
    seen = []

    @stencil_kernel.plain_under_mesh
    def est(x, *, mesh=None):
        seen.append((mesh, stencil_kernel.ENABLED))
        return x

    assert est(1) == 1 and est(2, mesh="m") == 2
    assert seen == [(None, True), ("m", False)]
    assert stencil_kernel.ENABLED
