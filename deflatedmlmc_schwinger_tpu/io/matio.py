"""Matrix ingestion: .mat file -> StencilOperator on device.

Behavioral parity with the reference loader (matrix.py:14-31):
  * reads key 'S' from the MATLAB file,
  * for schwinger16.mat the stored S is first multiplied by gamma_3 (the lower
    half of the rows is negated, reference: matrix.py:25-27),
  * the bare mass is added on the diagonal: D = S + m*I.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from deflatedmlmc_schwinger_tpu.io.stencil import stencil_from_csr
from deflatedmlmc_schwinger_tpu.ops.dirac import StencilOperator

def load_matrix(matrix_name: str, mass: float) -> sp.csr_matrix:
    """Load D = (gamma3-fixed) S + m*I from a MATLAB file as a host CSR
    matrix (scipy.io reader)."""
    import scipy.io as sio

    if not os.path.exists(matrix_name):
        raise FileNotFoundError(matrix_name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        contents = sio.loadmat(matrix_name)
    A = sp.csr_matrix(contents["S"])
    if os.path.basename(matrix_name) == "schwinger16.mat":
        half = A.shape[0] // 2
        A = sp.vstack([A[:half, :], -A[half:, :]]).tocsr()
    A = (A + mass * sp.identity(A.shape[0], dtype=A.dtype)).tocsr()
    return A


def infer_latt_dims(n: int) -> Tuple[int, int]:
    """Square-lattice dims from the matrix size (n = 2*L*L)."""
    L = int(round((n / 2) ** 0.5))
    if 2 * L * L != n:
        raise ValueError(f"cannot infer square lattice dims from n={n}")
    return (L, L)


def parse_generated_name(matrix_name: str):
    """Parse 'generated:<nx>x<nt>[:beta=<b>][:seed=<s>]' spec strings
    (operators sampled by io/gauge.py)."""
    if not matrix_name.startswith("generated:"):
        return None
    parts = matrix_name.split(":")
    nx, nt = (int(v) for v in parts[1].split("x"))
    beta, seed = 5.0, 0
    for p in parts[2:]:
        k, v = p.split("=")
        if k == "beta":
            beta = float(v)
        elif k == "seed":
            seed = int(v)
        else:
            raise ValueError(f"unknown generated-matrix option {k!r}")
    return nx, nt, beta, seed


def load_operator(
    matrix_name: str,
    mass: float,
    latt_dims: Optional[Tuple[int, int]] = None,
    dtype=None,
) -> Tuple[StencilOperator, Optional[sp.csr_matrix]]:
    """Load the Dirac operator as a device StencilOperator (+ the CSR oracle).

    ``matrix_name`` is a .mat file (key 'S') or a
    'generated:<nx>x<nt>:beta=<b>:seed=<s>' spec sampled from the exact
    quenched 2D U(1) ensemble (io/gauge.py); generated operators return None
    for the CSR oracle."""
    gen = parse_generated_name(matrix_name)
    if gen is not None:
        from deflatedmlmc_schwinger_tpu.io.gauge import generate_operator

        nx, nt, beta, seed = gen
        op = generate_operator(nx, nt, mass, beta=beta, seed=seed, dtype=dtype)
        return op, None
    A = load_matrix(matrix_name, mass)
    if latt_dims is None:
        latt_dims = infer_latt_dims(A.shape[0])
    nt, nx = int(latt_dims[0]), int(latt_dims[1])
    C = stencil_from_csr(A, nt=nt, nx=nx)
    if dtype is not None:
        C = C.astype(np.dtype(dtype))
    # Complex coeffs stay on the host: hierarchy setup reads them there, and
    # the device form is the (re, im) PairStencilOperator (ops/dirac.py).
    op = StencilOperator(coeffs=C, nx=nx, nt=nt)
    return op, A
