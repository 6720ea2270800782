"""The scipy .mat reader (io/matio.py) on files the tests write themselves."""

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from deflatedmlmc_schwinger_tpu.io import load_matrix, load_operator


def test_mat_roundtrip(tmp_path, op16):
    """S saved under key 'S' loads back as D = S + m I, as CSR and as the
    stencil operator, with the lattice inferred from n."""
    _, A = op16
    n = A.shape[0]
    S = (A - A.diagonal()[0] * sp.identity(n)).tocsc()
    path = tmp_path / "operator.mat"
    sio.savemat(path, {"S": S})
    mass = -0.25
    D = load_matrix(str(path), mass)
    assert abs(D - (S + mass * sp.identity(n))).max() < 1e-14
    op, D2 = load_operator(str(path), mass)
    assert (op.nx, op.nt) == (16, 16)
    x = np.random.default_rng(0).standard_normal((2, n)) + 0j
    np.testing.assert_allclose(np.asarray(op.matvec(x)), (D2 @ x.T).T, atol=1e-12)


def test_schwinger16_name_applies_gamma3(tmp_path, op16):
    """A file named schwinger16.mat stores gamma3 S (reference matrix.py:25-27):
    the loader negates the lower half of the rows back."""
    _, A = op16
    n = A.shape[0]
    g3 = sp.diags(np.r_[np.ones(n // 2), -np.ones(n // 2)])
    path = tmp_path / "schwinger16.mat"
    sio.savemat(path, {"S": (g3 @ A).tocsc()})
    D = load_matrix(str(path), 0.5)
    assert abs(D - (A + 0.5 * sp.identity(n))).max() < 1e-14


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_matrix(str(tmp_path / "absent.mat"), 0.0)
