"""Stalled-solve policy: under-solved probe rows (FGMRESResult.stalled) must
be counted, surfaced in the results, and -- past ``max_stalled_frac`` --
abort the run with a clear error instead of silently biasing the trace.

The reference solves every probe to 1e-12 unconditionally
(reference: gateway.py:148) so it cannot under-solve silently; our stall
cutoff (SolverConfig.stall_ratio) can, which is why the estimators enforce
the policy.

The forced-stall configuration is 128^2-shaped: the pinned 128^2 operator
with a deliberately crippled solver (restart far too small for the requested
tolerance), so every probe row exits above tol and is flagged.
"""

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.config import SolverConfig, TraceConfig
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy
from deflatedmlmc_schwinger_tpu.trace import hutchinson, mlmc
from deflatedmlmc_schwinger_tpu.trace.stats import check_stalled
from deflatedmlmc_schwinger_tpu.oracles import MASS16, MASS128, SPEC16, SPEC128


def cfg128_crippled(**kw):
    """Flagship-shaped config whose solver cannot reach the requested
    tolerance: 4 Arnoldi steps / single cycle against a 1e-13 target on the
    near-critical 128^2 operator stalls every row."""
    base = dict(
        matrix=SPEC128,
        mass=MASS128,
        latt_dims=(128, 128),
        max_nr_levels=3,
        aggrs=(16, 16),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        x_displacement=0,
        trace_tol=10.0,            # stop on min_nr_ests, not accuracy
        nr_deflat_vctrs=0,
        mlmc_deflat_vctrs=(0, 0),
        chebyshev_degree=8,
        subspace_iters=1,
        probe_batch=4,
        mlmc_levels_to_skip=(),
        function_tol=1e-13,
        solver=SolverConfig(restart=4, max_restarts=1),
    )
    base.update(kw)
    return TraceConfig(**base)


@pytest.fixture(scope="module")
def hier128_crippled(op128):
    op, _ = op128
    return setup_hierarchy(op, cfg128_crippled())


def test_check_stalled_threshold():
    check_stalled(0, 100, 0.05, "x")          # no stalls: fine
    check_stalled(5, 100, 0.05, "x")          # exactly at threshold: fine
    check_stalled(3, 0, 0.05, "x")            # no samples yet: fine
    with pytest.raises(RuntimeError, match="stalled"):
        check_stalled(6, 100, 0.05, "x")


def test_hutchinson_aborts_on_stalled_batch(op128, hier128_crippled):
    """Default policy: a batch whose rows all stall trips the error (here in
    the rough-trace phase -- the first batch solved)."""
    op, _ = op128
    cfg = cfg128_crippled()
    with pytest.raises(RuntimeError, match="stalled"):
        hutchinson(op, cfg, hier=hier128_crippled, verbose=False)


def test_hutchinson_reports_stalled_rows(op128, hier128_crippled):
    """With the policy relaxed the run completes and the result reports
    every under-solved row (rough batch + sampling batches) -- detection
    and reporting stay on even when aborting is off."""
    op, _ = op128
    cfg = cfg128_crippled(max_stalled_frac=1.0)
    r = hutchinson(op, cfg, hier=hier128_crippled, verbose=False)
    rough_rows = max(cfg.nr_rough_iters, cfg.probe_batch)
    assert r["stalled_rows"] == r["nr_ests"] + rough_rows
    assert r["nr_ests"] >= cfg.min_nr_ests


def test_mlmc_aborts_on_stalled_batch(op128, hier128_crippled):
    op, _ = op128
    cfg = cfg128_crippled()
    with pytest.raises(RuntimeError, match="stalled"):
        mlmc(op, cfg, hier=hier128_crippled, verbose=False)


def test_healthy_run_has_zero_stalled(op16):
    """A properly configured 16^2 run must not flag anything."""
    op, _ = op16
    cfg = TraceConfig(
        matrix=SPEC16,
        mass=MASS16,
        latt_dims=(16, 16),
        max_nr_levels=3,
        aggrs=(4, 4),
        dof=(2, 4, 4),
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        use_permuted=False,
        trace_tol=0.2,
        nr_deflat_vctrs=8,
        chebyshev_degree=30,
        subspace_iters=2,
        probe_batch=8,
        function_tol=1e-10,
    )
    r = hutchinson(op, cfg, verbose=False)
    assert r["stalled_rows"] == 0
