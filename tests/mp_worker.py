"""Worker process for the multi-process (multi-host) tests
(tests/test_multiprocess.py). Started as:

    python mp_worker.py <process_id> <num_processes> <port>

Each process brings 2 virtual CPU devices; jax.distributed.initialize forms
the 2x2 global mesh; the estimator runs with the probe batch sharded over all
four global devices and must print bit-identical results on every process
(counter-keyed probes + deterministic sample-order gather)."""

import json
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from deflatedmlmc_schwinger_tpu.parallel import initialize

initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
           process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc, jax.devices()

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.io import load_operator
from deflatedmlmc_schwinger_tpu.parallel import allgather_moments, make_mesh
from deflatedmlmc_schwinger_tpu.trace import hutchinson
from deflatedmlmc_schwinger_tpu.trace.stats import RunningMoments
from deflatedmlmc_schwinger_tpu.oracles import MASS16, SPEC16

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
    trace_tol=1e-8,        # never reached: exactly max_nr_ests samples
    max_nr_ests=16,
    probe_batch=8,
    nr_deflat_vctrs=4,
    chebyshev_degree=8,
    subspace_iters=2,
)
op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims)
mesh = make_mesh((2 * nproc,), ("samples",))
r = hutchinson(op, cfg, mesh=mesh, verbose=False)

# allgather_moments round-trip check: merging per-process COPIES of the same
# global moments must be a no-op-equivalent only when counts are split, so
# feed it a synthetic per-process half to validate the Chan merge across DCN
half = RunningMoments()
half.update_batch(
    __import__("numpy").arange(4, dtype=float) + (pid + 1) * 1j
)
merged = allgather_moments(half)

print(json.dumps(dict(
    pid=pid,
    trace_re=r["trace"].real, trace_im=r["trace"].imag,
    std_dev=r["std_dev"], nr_ests=r["nr_ests"],
    function_iters=r["function_iters"],
    merged_count=merged.count,
    merged_mean_re=merged.mean.real, merged_mean_im=merged.mean.imag,
    merged_m2=merged.m2,
)), flush=True)
