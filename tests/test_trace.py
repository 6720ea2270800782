"""Integration tests for the estimators against dense oracles
(SURVEY.md section 4: schwinger16 Hutchinson vs exact dense trace;
MLMC vs the dense telescoping identity; statistical agreement is sigma-aware).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg import MGSolver, setup_hierarchy
from deflatedmlmc_schwinger_tpu.trace import hutchinson, mlmc
from deflatedmlmc_schwinger_tpu.trace.stats import (
    ConfirmedStop,
    RunningMoments,
    should_stop,
)
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16


def cfg16(**kw):
    base = dict(
        matrix=SPEC16,
        mass=MASS16,
        latt_dims=(16, 16),
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
def setup16(op16):
    op, A = op16
    cfg = cfg16()
    hier = setup_hierarchy(op, cfg)
    return op, A, cfg, hier


def test_running_moments_match_reference_formulas():
    rng = np.random.default_rng(0)
    es = rng.standard_normal(37) + 1j * rng.standard_normal(37)
    m = RunningMoments()
    for chunk in np.array_split(es, 5):
        m.update_batch(chunk)
    # reference formulas (stoch_trace.py:143-147)
    avg = es.mean()
    dev = np.sqrt(np.mean(np.abs(es - avg) ** 2))
    assert abs(m.mean - avg) < 1e-12
    assert abs(m.std_dev - dev) < 1e-12
    assert abs(m.error_est - dev / np.sqrt(len(es))) < 1e-12
    stderr = dev / np.sqrt(len(es))
    assert should_stop(m, stderr / 2, 6) is False
    assert should_stop(m, stderr * 2, 6) is True
    assert should_stop(m, stderr * 2, 100) is False  # min-sample gate


def test_confirmed_stop_guard():
    """ConfirmedStop (config.py stop_confirm): disabled = passthrough;
    enabled = stop only on two passing checks separated by more samples,
    and any intervening failure disarms the pending stop."""
    s = ConfirmedStop(False)
    assert s(True, 10) is True           # passthrough when disabled
    s = ConfirmedStop(True)
    assert s(False, 10) is False
    assert s(True, 20) is False          # first crossing arms only
    assert s(True, 20) is False          # same count: not a new batch yet
    assert s(True, 28) is True           # confirmed one batch later
    s = ConfirmedStop(True)
    assert s(True, 8) is False
    assert s(False, 16) is False         # failure disarms...
    assert s(True, 24) is False          # ...so this re-arms
    assert s(True, 32) is True


def test_confirmed_stop_estimator_contract(setup16, exact16):
    """With stop_confirm the estimator still stops and still meets the
    stderr target (at worst one extra batch of samples)."""
    op, A, cfg, hier = setup16
    r = hutchinson(op, cfg.replace(stop_confirm=True), hier=hier, verbose=False)
    stderr = r["std_dev"] / np.sqrt(r["nr_ests"])
    target = abs(cfg.trace_tol * r["rough_trace"])
    assert stderr < target
    err = abs(r["trace"] - exact16)
    assert err < 5 * max(stderr, 1e-12) + 1e-6, (r["trace"], stderr)


def test_hutchinson_16(setup16, exact16):
    op, A, cfg, hier = setup16
    r = hutchinson(op, cfg, hier=hier, verbose=False)
    stderr = max(r["std_dev"] / np.sqrt(r["nr_ests"]), 1e-12)
    err = abs(r["trace"] - exact16)
    # 5-sigma statistical agreement with the exact dense trace
    assert err < 5 * stderr + 1e-6, (r["trace"], stderr)
    assert r["nr_ests"] >= cfg.min_nr_ests
    assert r["function_iters"] > 0
    assert r["total_complexity"] > 0


def test_mlmc_16_totals(setup16, exact16):
    op, A, cfg, hier = setup16
    r = mlmc(op, cfg, hier=hier, verbose=False)
    devs = [
        res["ests_dev"] / max(np.sqrt(res["nr_ests"]), 1) for res in r["results"]
    ]
    stderr = max(np.sqrt(sum(d * d for d in devs)), 1e-12)
    err = abs(r["trace"] - exact16)
    assert err < 5 * stderr + 1e-6, (r["trace"], stderr)
    # coarsest level is exact
    assert r["results"][-1]["ests_dev"] == 0.0
    assert r["results"][-1]["nr_ests"] == 1


def test_mlmc_telescoping_identity_dense(setup16, exact16):
    """The hierarchy's own telescoping sum reproduces the exact trace
    (pure linear algebra, no sampling; survey section 4 oracle)."""
    op, A, cfg, hier = setup16
    Ad = np.asarray(A.todense())
    A0inv = np.linalg.inv(Ad)
    P0 = hier.levels[0].P.to_dense()
    A1 = hier.levels[1].op.complex_matrix()
    A1inv = np.linalg.inv(A1)
    P1 = hier.levels[1].P.to_dense()
    A2 = hier.levels[2].op.complex_matrix()
    A2inv = np.linalg.inv(A2)
    t0 = np.trace(A0inv - P0 @ A1inv @ P0.conj().T)
    t1 = np.trace(A1inv - P1 @ A2inv @ P1.conj().T)
    t2 = np.trace(A2inv)
    total = t0 + t1 + t2
    assert abs(total - np.trace(A0inv)) < 1e-9
    assert abs(total - exact16) < 1e-6


def test_mlmc_skip_level(setup16, exact16):
    op, A, cfg, hier = setup16
    cfg_skip = cfg.replace(mlmc_levels_to_skip=(1,), mlmc_deflat_vctrs=(8, 0))
    r = mlmc(op, cfg_skip, hier=hier, verbose=False)
    # level 1 must be skipped entirely
    assert r["results"][1]["nr_ests"] == 0
    devs = [
        res["ests_dev"] / max(np.sqrt(res["nr_ests"]), 1) for res in r["results"]
    ]
    stderr = max(np.sqrt(sum(d * d for d in devs)), 1e-12)
    assert abs(r["trace"] - exact16) < 5 * stderr + 1e-6


def test_mlmc_rejects_bad_skip(setup16):
    op, A, cfg, hier = setup16
    with pytest.raises(Exception, match="skip"):
        mlmc(op, cfg.replace(mlmc_levels_to_skip=(0,)), hier=hier, verbose=False)
    with pytest.raises(Exception, match="skip"):
        mlmc(op, cfg.replace(mlmc_levels_to_skip=(0, 1)), hier=hier, verbose=False)


def test_mlmc_adaptive_schedule(setup16, exact16):
    """SURVEY.md P2: optimal-allocation interleaved scheduling meets the
    AGGREGATE tolerance contract and still matches the dense oracle."""
    op, A, cfg, hier = setup16
    c = cfg.replace(mlmc_schedule="adaptive")
    r = mlmc(op, c, hier=hier, verbose=False)
    err = abs(r["trace"] - exact16)
    stderr = max(r["std_dev"], 1e-12)
    assert err < 5 * stderr + 1e-6, (r["trace"], stderr)
    # the aggregate stderr meets the total budget (the adaptive contract)
    eps_tot = abs(c.trace_tol * r["rough_trace"])
    assert r["std_dev"] < eps_tot
    for res in r["results"][:-1]:
        assert res["nr_ests"] >= c.min_nr_ests
    assert r["results"][-1]["nr_ests"] == 1  # exact coarsest unchanged


def test_mlmc_rejects_unknown_schedule(setup16):
    op, A, cfg, hier = setup16
    with pytest.raises(ValueError):
        mlmc(op, cfg.replace(mlmc_schedule="nope"), hier=hier, verbose=False)


def test_mlmc_exact_dense_levels(setup16, exact16):
    """mlmc_exact_dense_max_n (generalization of the reference's
    exact-coarsest rule, stoch_trace.py:418-437): difference levels under the
    cutoff are computed exactly (zero variance, one 'estimate'), the exact
    value equals the dense telescoping term, and the total still matches the
    dense oracle. Sampled level 0 applies the precomputed dense inverse of
    its coarse operator instead of an iterative solve."""
    op, A, cfg, hier = setup16
    c = cfg.replace(mlmc_exact_dense_max_n=300, mlmc_deflat_vctrs=(8, 0))
    r = mlmc(op, c, hier=hier, verbose=False)
    # level sizes are (512, 256, 64): level-1 difference is exact
    assert r["results"][1]["nr_ests"] == 1
    assert r["results"][1]["ests_dev"] == 0.0
    # the exact level equals the dense telescoping term of THIS hierarchy
    A1 = hier.levels[1].op.complex_matrix()
    P1 = hier.levels[1].P.to_dense()
    A2 = hier.levels[2].op.complex_matrix()
    t1 = np.trace(np.linalg.inv(A1) - P1 @ np.linalg.inv(A2) @ P1.conj().T)
    assert abs(complex(r["results"][1]["ests_avg"]) - t1) < 1e-6 * max(abs(t1), 1)
    # total against the dense oracle, 5-sigma (level-0 stderr only)
    stderr = max(r["std_dev"], 1e-12)
    assert abs(r["trace"] - exact16) < 5 * stderr + 1e-6, (r["trace"], stderr)


def test_mlmc_fine_deflation(setup16, exact16):
    """mlmc_fine_deflation: level-0 difference probes deflated with the
    Hutchinson gamma3 basis, removed subspace added back exactly by the
    U-column correction batch -- the estimator stays unbiased (dense
    oracle, 5-sigma) and the level-0 deviation does not exceed the
    undeflated run's."""
    op, A, cfg, hier = setup16
    base = cfg.replace(mlmc_deflat_vctrs=(0, 0), mlmc_exact_dense_max_n=300)
    r0 = mlmc(op, base, hier=hier, verbose=False)
    c = base.replace(mlmc_fine_deflation=True)
    r = mlmc(op, c, hier=hier, verbose=False)
    stderr = max(r["std_dev"], 1e-12)
    assert abs(r["trace"] - exact16) < 5 * stderr + 1e-6, (r["trace"], stderr)
    assert r["results"][0]["ests_dev"] <= 1.2 * r0["results"][0]["ests_dev"]
    # conflict with the reference-style level-0 deflation is rejected
    with pytest.raises(ValueError, match="mlmc_fine_deflation"):
        mlmc(op, c.replace(mlmc_deflat_vctrs=(8, 0)), hier=hier, verbose=False)


def test_hutchinson_rough_batch_full(setup16, exact16):
    """rough_batch_full averages the whole padded rough batch (a
    tightening of the stopping target; reference uses 5 probes,
    stoch_trace.py:104) -- the estimator still stops and lands within
    statistics of the dense oracle."""
    op, A, cfg, hier = setup16
    cfg = cfg.replace(rough_batch_full=True)
    r = hutchinson(op, cfg, hier=hier, verbose=False)
    stderr = max(r["std_dev"] / np.sqrt(r["nr_ests"]), 1e-12)
    err = abs(r["trace"] - exact16)
    assert err < 5 * stderr + 1e-6, (r["trace"], stderr)
    # the stopping target followed the rough trace, which now tracks the
    # true trace to the batch-mean stderr
    assert r["rough_trace"] != 0
