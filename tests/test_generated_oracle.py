"""Correctness oracles for GENERATED gauge ensembles.

Every named config runs on a lattice sampled by io/gauge.py.  These tests pin the
generator + estimator stack against exact dense traces computed once for
small generated lattices (same ensemble construction, same seeding scheme),
so a regression anywhere in sample_links -> stencil_from_links -> estimators
shows up against an absolute oracle:

  * 32^2 (n=2048,  mass=-0.22, beta=5.0, seed=11): dense tr(D^-1) recomputed
    in-test and compared to the pinned value (guards the generator's RNG
    stream and stencil algebra bit-for-bit at the trace level);
  * 64^2 (n=8192, same ensemble parameters): dense inverse takes ~70 s, so
    only the PINNED value is used (recorded 2026-08-19 from
    np.trace(np.linalg.inv(csr_from_stencil(coeffs).todense())));
  * 128^2 (G102/G202: beta=5.0, seed=8, mass = 0.99 * m_crit, displaced at
    x_disp=2): EXACT128 = oracles.TRACE128, tr(D^-1 Pi^T) in complex128 from
    a sparse LU solved against all 32768 unit columns (oracles.py recipe;
    recomputed by tests/test_oracles.py under the slow marker).

gamma3-Hermiticity holds for ANY U(1) configuration (io/gauge.py docstring);
checked here on the 64^2 operator as the cheap structural diagnostic the
generated production configs rely on.
"""

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu import oracles
from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.io.gauge import generate_operator
from deflatedmlmc_schwinger_tpu.io.stencil import csr_from_stencil
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy
from deflatedmlmc_schwinger_tpu.trace import hutchinson, mlmc

MASS = -0.22
BETA = 5.0
SEED = 11

# dense-inverse oracles, pinned (see module docstring)
EXACT32 = 355.550621261975
EXACT64 = 1362.710619261613
EXACT128 = oracles.TRACE128   # beta, seed, mass and method in oracles.py


def gen_cfg32(**kw):
    base = dict(
        matrix="<generated>",
        mass=MASS,
        latt_dims=(32, 32),
        max_nr_levels=3,
        aggrs=(4, 4),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        trace_tol=1e-2,
        nr_deflat_vctrs=24,
        mlmc_deflat_vctrs=(8, 8),
        defl_type="exact",
        chebyshev_degree=50,
        subspace_iters=4,
        probe_batch=8,
        mlmc_levels_to_skip=(),
    )
    base.update(kw)
    return TraceConfig(**base)


@pytest.fixture(scope="module")
def gen32():
    op = generate_operator(32, 32, MASS, beta=BETA, seed=SEED)
    cfg = gen_cfg32()
    hier = setup_hierarchy(op, cfg)
    return op, cfg, hier


def test_generated_32_dense_trace_matches_pinned_oracle():
    """Recompute the 32^2 dense trace: pins the quenched-ensemble RNG stream
    and the Wilson stencil algebra to the recorded oracle."""
    op = generate_operator(32, 32, MASS, beta=BETA, seed=SEED)
    A = np.asarray(csr_from_stencil(np.asarray(op.coeffs)).todense())
    tr = np.trace(np.linalg.inv(A))
    assert abs(tr.real - EXACT32) < 1e-6
    assert abs(tr.imag) < 1e-6


def test_generated_64_gamma3_hermiticity():
    """Q = gamma3 D must be exactly Hermitian for any U(1) configuration
    (reference: multigrid.py:130-133; the structural diagnostic available on
    lattices too large for a dense oracle)."""
    op = generate_operator(64, 64, MASS, beta=BETA, seed=SEED)
    A = csr_from_stencil(np.asarray(op.coeffs)).tocsr()
    half = A.shape[0] // 2
    Q = A.tolil(copy=True)
    Q[half:, :] = -Q[half:, :]
    Q = Q.tocsr()
    assert abs(Q - Q.getH()).max() < 1e-12


def test_generated_32_hutchinson_vs_oracle(gen32):
    op, cfg, hier = gen32
    r = hutchinson(op, cfg, hier=hier, verbose=False)
    stderr = max(r["std_dev"] / np.sqrt(r["nr_ests"]), 1e-12)
    assert abs(r["trace"] - EXACT32) < 5 * stderr + 1e-6, (r["trace"], stderr)


def test_generated_32_mlmc_vs_oracle_and_cross_estimator(gen32):
    """MLMC on the generated ensemble agrees with the dense oracle -- and
    therefore with Hutchinson (the G301 cross-estimator contract, checked
    here transitively against the stronger absolute oracle)."""
    op, cfg, hier = gen32
    r = mlmc(op, cfg, hier=hier, verbose=False)
    tol = abs(cfg.trace_tol * EXACT32)
    assert abs(r["trace"] - EXACT32) < 5 * tol, r["trace"]
