"""The pinned operators and exact traces (oracles.py).

The 16^2 values are recomputed in-test. The 128^2 recompute takes ~20
minutes on two CPU cores and runs only under the ``slow`` marker; the
recipe itself is checked here against a dense inverse at 16^2."""

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu import gateway, oracles


def test_critical_mass_16_matches_pinned():
    mc = oracles.critical_mass(16, 16, oracles.BETA16, oracles.SEED16)
    assert abs(mc - oracles.M_CRIT16) < 1e-10


def test_mass_rule_puts_spectrum_one_percent_above_zero(dense16):
    lam = np.linalg.eigvals(dense16)
    assert abs(lam.real.min() - 0.01 * abs(oracles.M_CRIT16)) < 1e-10


def test_exact_displaced_trace_matches_dense_inverse():
    m = oracles.MASS16
    A = oracles.operator_csr(16, 16, oracles.BETA16, oracles.SEED16, m).toarray()
    d = 2 * 16 * 2
    n = A.shape[0]
    Pi = np.roll(np.eye(n), d, axis=1)          # (Pi v)[i] = v[(i + d) % n]
    want = np.trace(np.linalg.inv(A) @ Pi.T)
    got = oracles.exact_displaced_trace(16, 16, oracles.BETA16, oracles.SEED16,
                                        m, 2, block=100)
    assert abs(got - want) < 1e-10 * abs(want)
    plain = oracles.exact_displaced_trace(16, 16, oracles.BETA16, oracles.SEED16,
                                          m, 0)
    assert abs(plain - np.trace(np.linalg.inv(A))) < 1e-10 * abs(plain)


def test_gateway_configs_use_pinned_operators():
    c16 = gateway.set_params("schwinger16")
    c128 = gateway.set_params("schwinger128")
    assert (c16.matrix, c16.mass) == (oracles.SPEC16, oracles.MASS16)
    assert (c128.matrix, c128.mass) == (oracles.SPEC128, oracles.MASS128)
    assert c128.use_permuted and c128.x_displacement == oracles.X_DISP128
    assert oracles.MASS128 == 0.99 * oracles.M_CRIT128


@pytest.mark.slow
def test_recompute_128_oracle():
    got = oracles.recompute()
    assert abs(got["M_CRIT16"] - oracles.M_CRIT16) < 1e-10
    assert abs(got["M_CRIT128"] - oracles.M_CRIT128) < 1e-9
    assert abs(got["TRACE128"] - oracles.TRACE128) < 1e-9 * abs(oracles.TRACE128)
