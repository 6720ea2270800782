"""Quenched 2D U(1) gauge-configuration generator -> Wilson--Dirac operators
for every named config (gateway.py; pinned oracles in oracles.py).

The reference's Schwinger matrices have exactly this algebra (checked to
0.0 against its 128^2 matrix when that file was available):

    D = (m + 4) I
        + u_t(x,t)       (1 - sigma1) delta_{t+1}
        + conj(u_t(x,t-1)) (1 + sigma1) delta_{t-1}
        + u_x(x,t)       (1 - sigma2) delta_{x+1}
        + conj(u_x(x-1,t)) (1 + sigma2) delta_{x-1}

with unit-modulus link phases u_t, u_x (gamma_t = sigma1, gamma_x = sigma2,
gamma3 = sigma3; Q = gamma3 D is Hermitian for ANY U(1) configuration).
Generating a new lattice therefore means sampling the two link-phase fields.

Sampling is the exact quenched ensemble: in 2D the Wilson gauge action
factorizes over plaquettes, so plaquette angles are i.i.d. von Mises(beta)
(up to one constrained plaquette per x-column from temporal periodicity --
the standard construction). Links are built in temporal gauge u_t = 1 with a
uniformly random Polyakov line per column; beta controls the roughness of the
configuration and thereby the MG/deflation difficulty.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deflatedmlmc_schwinger_tpu.ops.dirac import StencilOperator

SIGMA1 = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
SIGMA2 = np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=complex)
I2 = np.eye(2, dtype=complex)


def sample_links(
    nx: int, nt: int, beta: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (theta_t, theta_x) link angles, each (nx, nt), from the exact
    2D quenched U(1) ensemble at coupling ``beta``."""
    rng = np.random.default_rng(seed)
    plaq = rng.vonmises(0.0, beta, size=(nx, nt))
    # temporal gauge: u_t = 1 everywhere; plaq(x,t) = th_x(x,t) - th_x(x,t+1)
    # => th_x(x,t) = th_x(x,0) - cumsum_{t'<t} plaq(x,t')
    th_x0 = rng.uniform(-np.pi, np.pi, size=(nx, 1))  # random Polyakov lines
    csum = np.concatenate(
        [np.zeros((nx, 1)), np.cumsum(plaq, axis=1)[:, :-1]], axis=1
    )
    theta_x = th_x0 - csum
    theta_t = np.zeros((nx, nt))
    return theta_t, theta_x


def stencil_from_links(
    theta_t: np.ndarray, theta_x: np.ndarray, mass: float
) -> np.ndarray:
    """Build (2, 2, 5, nx, nt) Wilson--Dirac stencil coefficients from link
    angles (the exact algebra of the shipped matrices; taps as ops/dirac.py)."""
    nx, nt = theta_t.shape
    u = np.exp(1j * theta_t)  # t-direction links at (x, t)
    v = np.exp(1j * theta_x)  # x-direction links at (x, t)
    C = np.zeros((2, 2, 5, nx, nt), dtype=complex)
    C[:, :, 0] = (mass + 4.0) * I2[:, :, None, None]
    C[:, :, 1] = (I2 - SIGMA1)[:, :, None, None] * u
    C[:, :, 2] = (I2 + SIGMA1)[:, :, None, None] * np.conj(np.roll(u, 1, axis=1))
    C[:, :, 3] = (I2 - SIGMA2)[:, :, None, None] * v
    C[:, :, 4] = (I2 + SIGMA2)[:, :, None, None] * np.conj(np.roll(v, 1, axis=0))
    return C


def generate_operator(
    nx: int,
    nt: int,
    mass: float,
    *,
    beta: float = 5.0,
    seed: int = 0,
    dtype=None,
) -> StencilOperator:
    """Generate a quenched 2D Schwinger Wilson--Dirac StencilOperator.

    Same host-resident complex coefficient layout as io/matio.load_operator;
    convert with ops.dirac.pair_operator for the device path."""
    theta_t, theta_x = sample_links(nx, nt, beta, seed)
    C = stencil_from_links(theta_t, theta_x, mass)
    if dtype is not None:
        C = C.astype(np.dtype(dtype))
    return StencilOperator(coeffs=C, nx=nx, nt=nt)
