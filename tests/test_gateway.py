"""End-to-end coverage of the entry layers L6-L4: gateway configs ->
example drivers -> estimators -> reference-format report (SURVEY.md C1-C3;
reference main.py/gateway.py/examples.py). Runs the repaired 16^2 configs
on CPU against the dense-inverse trace of the pinned 16^2 operator
(tests/conftest.py exact16)."""

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu import gateway


def test_g101_end_to_end(capsys, exact16):
    r = gateway.G101()
    out = capsys.readouterr().out
    # estimate within its own reported uncertainty of the dense oracle
    stderr = r["std_dev"] / np.sqrt(r["nr_ests"])
    assert abs(r["trace"] - exact16) < max(4.0 * stderr, 0.05 * abs(exact16))
    assert r["nr_ests"] >= 6                       # reference minimum
    # the reference-format report and the JSON line were printed
    assert "Example 01" in out and "number of estimates" in out
    assert '"example": "hutchinson"' in out


def test_g201_end_to_end(capsys, exact16):
    r = gateway.G201()
    out = capsys.readouterr().out
    stderr = max(r["std_dev"], 1e-12)
    assert abs(r["trace"] - exact16) < max(4.0 * stderr, 0.05 * abs(exact16))
    assert "Example 02" in out and "-- level : 0" in out
    assert '"example": "mlmc"' in out


def test_unknown_config_rejected():
    with pytest.raises(Exception):
        gateway.set_params("no-such-experiment")
