"""Gauge-config generator: gamma3-Hermiticity, matvec and loading of
generated operators."""

import numpy as np

from deflatedmlmc_schwinger_tpu.io.gauge import generate_operator
from deflatedmlmc_schwinger_tpu.io.stencil import csr_from_stencil


def test_generated_gamma3_hermitian():
    op = generate_operator(16, 16, mass=-0.3, beta=4.0, seed=7)
    A = csr_from_stencil(np.asarray(op.coeffs)).todense()
    g3 = np.kron(np.diag([1.0, -1.0]), np.eye(16 * 16))
    Q = g3 @ A
    assert np.abs(Q - Q.conj().T).max() < 1e-13
    # not Hermitian itself
    assert np.abs(A - A.conj().T).max() > 0.1


def test_generated_matvec_matches_csr():
    op = generate_operator(8, 8, mass=-0.2, beta=2.0, seed=3)
    A = csr_from_stencil(np.asarray(op.coeffs))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, op.n)) + 1j * rng.standard_normal((3, op.n))
    y = np.asarray(op.matvec(x))
    np.testing.assert_allclose(y, (A @ x.T).T, atol=1e-12)


def test_beta_controls_roughness():
    """Higher beta -> smoother config -> plaquette angles concentrated."""
    from deflatedmlmc_schwinger_tpu.io.gauge import sample_links

    _, thx_smooth = sample_links(32, 32, beta=50.0, seed=1)
    _, thx_rough = sample_links(32, 32, beta=0.5, seed=1)
    # plaquette spread (diff along t reconstructs plaquettes)
    sm = np.std(np.diff(thx_smooth, axis=1))
    rg = np.std(np.diff(thx_rough, axis=1))
    assert sm < 0.3 < rg


def test_generated_name_loading_end_to_end():
    """'generated:NxT:...' specs load through io.load_operator and run the
    full deflated-Hutchinson pipeline; estimate checked against the dense
    exact trace (the generated-config analog of the 16^2 oracle test)."""
    import jax.numpy as jnp

    from deflatedmlmc_schwinger_tpu.config import TraceConfig
    from deflatedmlmc_schwinger_tpu.io import load_operator
    from deflatedmlmc_schwinger_tpu.io.matio import parse_generated_name
    from deflatedmlmc_schwinger_tpu.trace import hutchinson

    assert parse_generated_name("generated:32x16:beta=3.5:seed=2") == (32, 16, 3.5, 2)
    assert parse_generated_name("schwinger16.mat") is None

    cfg = TraceConfig(
        matrix="generated:16x16:beta=4.0:seed=7",
        mass=-0.30,
        latt_dims=(16, 16),
        trace_tol=5.0e-2,
        max_nr_levels=3,
        aggrs=(2 * 2, 2 * 2),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        x_displacement=0,
        nr_deflat_vctrs=16,
        chebyshev_degree=16,
        subspace_iters=3,
        probe_batch=16,
        dtype=jnp.complex128,
    )
    op, oracle = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims)
    assert oracle is None and op.n == 512

    from deflatedmlmc_schwinger_tpu.io.stencil import csr_from_stencil
    import numpy as np

    A = csr_from_stencil(np.asarray(op.coeffs)).todense()
    exact = complex(np.trace(np.linalg.inv(A)))

    result = hutchinson(op, cfg, verbose=False)
    err = abs(result["trace"] - exact)
    # statistical agreement: within 5 standard errors of the stopping target
    assert err < 5 * max(result["std_dev"] / np.sqrt(result["nr_ests"]),
                         abs(cfg.trace_tol * exact))
