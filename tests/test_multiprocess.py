"""Multi-process (multi-host) tests with a local TCP coordinator (SURVEY.md
section 4 distributed test plan): two jax processes,
2 virtual CPU devices each, form a 4-device global 'samples' mesh; the
deflated-Hutchinson estimator must produce BIT-IDENTICAL results on both
processes (counter-keyed probes + deterministic sample-order gather,
parallel/distributed.py global_values) and match the single-process run."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def mp_results():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=560)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        assert p.returncode == 0, err[-3000:]
        # gloo prints connection banners on stdout, sometimes WITHOUT a
        # trailing newline, so the worker's JSON may share a line with a
        # banner fragment -- scan for the marker instead of line starts
        json_lines = []
        for line in out.splitlines():
            i = line.find('{"pid"')
            if i >= 0:
                json_lines.append(line[i:])
        assert json_lines, (out, err[-2000:])
        outs.append(json.loads(json_lines[-1]))
    return sorted(outs, key=lambda d: d["pid"])


def test_two_process_estimator_bit_identical(mp_results):
    r0, r1 = mp_results
    assert r0["nr_ests"] == r1["nr_ests"] == 16
    assert r0["trace_re"] == r1["trace_re"]
    assert r0["trace_im"] == r1["trace_im"]
    assert r0["std_dev"] == r1["std_dev"]
    assert r0["function_iters"] == r1["function_iters"]


def test_two_process_matches_single_process(mp_results, op16):
    from deflatedmlmc_schwinger_tpu.config import TraceConfig
    from deflatedmlmc_schwinger_tpu.parallel import make_mesh
    from deflatedmlmc_schwinger_tpu.trace import hutchinson

    cfg = TraceConfig(
        matrix=SPEC16, mass=MASS16, latt_dims=(16, 16),
        max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low",
        test_vectors_type="RSVs", use_permuted=False, trace_tol=1e-8,
        max_nr_ests=16, probe_batch=8, nr_deflat_vctrs=4,
        chebyshev_degree=8, subspace_iters=2,
    )
    op, _ = op16
    import jax

    mesh = make_mesh((4,), ("samples",), devices=jax.devices()[:4])
    r = hutchinson(op, cfg, mesh=mesh, verbose=False)
    r0 = mp_results[0]
    trace2 = complex(r0["trace_re"], r0["trace_im"])
    # same counter-keyed samples; numerics may differ in the last ulps
    # across process topologies
    assert abs(r["trace"] - trace2) < 1e-8 * abs(r["trace"]), (r["trace"], trace2)
    assert r["nr_ests"] == r0["nr_ests"]


def test_allgather_moments_across_processes(mp_results):
    """Each worker merged a synthetic per-process moment set over DCN; the
    result must equal the host-side Chan merge of both halves."""
    from deflatedmlmc_schwinger_tpu.trace.stats import RunningMoments

    expect = RunningMoments()
    expect.update_batch(np.arange(4, dtype=float) + 1j)
    other = RunningMoments()
    other.update_batch(np.arange(4, dtype=float) + 2j)
    expect = expect.merge(other)
    for r in mp_results:
        assert r["merged_count"] == expect.count
        assert abs(complex(r["merged_mean_re"], r["merged_mean_im"]) - expect.mean) < 1e-12
        assert abs(r["merged_m2"] - expect.m2) < 1e-9
