"""Experiment gateway: named configurations and G1xx/G2xx wrappers
(reference: gateway.py:10-169).

The reference's two .mat operators are not shipped, so the 16^2 and 128^2
configs run on generated quenched configurations pinned in oracles.py, at
the reference's mass rule m = 0.99 * m_crit. Known reference defect handled
here (SURVEY.md section 2.1): the reference's schwinger16 param set misses
several required keys and its dof=[2,2,2] hierarchy has a singular coarsest
operator. This gateway ships the repaired 16^2 configuration (dof=(2,4,4),
missing knobs filled from the 128^2 set, use_permuted=False).
"""

from __future__ import annotations

from deflatedmlmc_schwinger_tpu import oracles
from deflatedmlmc_schwinger_tpu.config import SolverConfig, TraceConfig
from deflatedmlmc_schwinger_tpu.examples import EXAMPLE_001, EXAMPLE_002


def set_params(example_name: str) -> TraceConfig:
    if example_name == "schwinger16":
        # reference: gateway.py:65-96 (repaired)
        return TraceConfig(
            matrix=oracles.SPEC16,
            problem_name="schwinger",
            mass=oracles.MASS16,
            latt_dims=(16, 16),
            trace_tol=1.0e-2,
            max_nr_levels=3,
            coarsest_level_directly=True,
            accuracy_mg_eigvs="low",
            nr_deflat_vctrs=64,
            mlmc_deflat_vctrs=(16, 16),
            mlmc_levels_to_skip=(1,),
            aggrs=(2 * 2, 2 * 2),
            dof=(2, 4, 4),          # reference (2,2,2) coarsest is singular
            defl_type="exact",
            defl_eigvs_tol_Hutch=1.0e-9,
            defl_eigvs_tol_MLMC=1.0e-1,
            diff_lev_op_tol=1.0e-3,
            use_permuted=False,
            x_displacement=0,
            check_quality_MG=False,
            test_vectors_type="EVs",
            seed=51234,
        )
    elif example_name == "schwinger128":
        # reference: gateway.py:98-166, displaced trace at x_disp=2; the
        # exact value is oracles.TRACE128.
        #
        # The tuned profile: `python main.py G102` / `G202` run it, and
        # bench.py and chip_smoke.py import it. For a reference-fidelity run
        # (EVs/'high'/k=8/tol 1e-12) use 'schwinger128-parity' below. Knobs
        # that deviate from the reference:
        import jax.numpy as jnp

        return TraceConfig(
            matrix=oracles.SPEC128,
            problem_name="schwinger",
            mass=oracles.MASS128,
            latt_dims=(128, 128),
            trace_tol=1.0e-2,
            aggrs=(4 * 4, 2 * 2, 2 * 2),
            dof=(2, 8, 8, 8),
            max_nr_levels=4,
            coarsest_level_directly=True,
            # 'low' + RSVs: hierarchy quality is statistically identical for
            # the estimator at a fraction of the setup cost
            accuracy_mg_eigvs="low",
            check_quality_MG=False,
            test_vectors_type="RSVs",
            mlmc_levels_to_skip=(1,),
            # 128 deflation vectors from a LOOSE-tolerance inverse iteration:
            # k=8->64 cut the per-probe deviation 167->81 (so ~4x fewer
            # probes), k 96->128 cut it 71->67, and 1e-2 basis solves gave
            # the same deviation as 1e-4 (inexact inverse iteration needs
            # only ~1e-2 per round). tr1 stays exact for any basis quality
            # (correction_mode='solve').
            nr_deflat_vctrs=128,
            defl_eigvs_tol_Hutch=1.0e-2,
            # 3 inverse-iteration rounds: deviation 69.4 vs 68.7 at 5
            # rounds (a ~2% sample surcharge) for 2 fewer rounds of solves.
            # A Chebyshev warm-filter start (defl_warm_filter_degree) gave a
            # worse deviation here; keep it off with an MG-driven iteration.
            defl_subspace_rounds=3,
            # defl_buffer=probe_batch makes every setup solve reuse the
            # sampling batch's XLA program (config.py defl_buffer)
            defl_buffer=128,
            mlmc_deflat_vctrs=(0, 0, 0),
            defl_type="exact",
            defl_eigvs_tol_MLMC=1.0e-1,
            diff_lev_op_tol=1.0e-3,
            # G202 (MLMC) profile: levels at or below 4096 unknowns are
            # computed exactly (dense f64 on host) -- the f32 iterative
            # coarse solves floor at ~1e-2 relative residual, and dense
            # levels contribute zero variance; the level-0 difference probes
            # reuse the k=128 gamma3 basis with an exact one-batch add-back,
            # which cut the level-0 deviation 841 -> 73 (undeflated
            # estimates carry O(100) f32 solve noise from
            # 1/|lambda_min|-sized solutions). The level-0 coarse solve
            # applies the precomputed dense level-2 inverse as one matmul.
            mlmc_exact_dense_max_n=4096,
            mlmc_fine_deflation=True,
            # average the whole padded rough batch: the reference's 5-probe
            # rough trace scatters by +-75%, turning the "1%" stopping target
            # into 0.5-4% actual error; 128 rough probes cost one batch and
            # pin the target at the true 1%
            rough_batch_full=True,
            # stop at 0.7x the target stderr: the realized |error| of an
            # unbiased complex estimate is Rayleigh-distributed, so stopping
            # AT the target fails the contract with probability 1/e = 37%,
            # at 0.8x still 21%, at 0.7x ~13%, at 0.6x ~6% (config.py
            # stop_safety), plus the confirmation batch (stop_confirm)
            stop_safety=0.7,
            stop_confirm=True,
            use_permuted=True,
            x_displacement=2,
            seed=51234,
            # throughput knobs: restart 40 with 128-probe batches
            probe_batch=128,
            chebyshev_degree=60,
            subspace_iters=8,
            dtype=jnp.complex64,
            # smoother depth 16: deeper GMRES-poly smoothing trades stencil
            # work for outer Arnoldi iterations -- si 4 -> 16 cut iters_max
            # 108 -> 33 at tol 5e-4 (restart 40; relres certified, 0
            # stalls), and each saved outer iteration removes a full
            # V-cycle + Arnoldi step. Whether that trade pays on the GPU is
            # not measured.
            solver=SolverConfig(restart=40, smoother="poly", smooth_iters=16),
            # deflation setup keeps the shallow profile: its near-kernel
            # solves are stall-cutoff-bound, so their cost scales with the
            # per-iteration price (config.py defl_solver)
            defl_solver=SolverConfig(restart=40, smoother="poly"),
            # sampling solves at the bias-bounded f32 target instead of the
            # c64 floor (3e-7): tests/test_bias.py bounds the trace bias of
            # 5e-4-tolerance solves far under the 1% budget, and solves at
            # the floor run past the stall cutoff
            function_tol=5.0e-4,
        )
    elif example_name == "schwinger128-parity":
        # reference-fidelity variant of the 128^2 config: EVs at 'high'
        # eigensolver accuracy, k=8 deflation at 1e-9, solves at 1e-12
        # (clipped to the dtype's residual floor), reference rough trace and
        # stopping rule (reference: gateway.py:98-166)
        return TraceConfig(
            matrix=oracles.SPEC128,
            problem_name="schwinger",
            mass=oracles.MASS128,
            latt_dims=(128, 128),
            trace_tol=1.0e-2,
            aggrs=(4 * 4, 2 * 2, 2 * 2),
            dof=(2, 8, 8, 8),
            max_nr_levels=4,
            coarsest_level_directly=True,
            accuracy_mg_eigvs="high",
            check_quality_MG=False,
            test_vectors_type="EVs",
            mlmc_levels_to_skip=(1,),
            nr_deflat_vctrs=8,
            mlmc_deflat_vctrs=(0, 0, 0),
            defl_type="exact",
            defl_eigvs_tol_Hutch=1.0e-9,
            defl_eigvs_tol_MLMC=1.0e-1,
            diff_lev_op_tol=1.0e-3,
            use_permuted=True,
            x_displacement=2,
            seed=51234,
            function_tol=1.0e-12,
            probe_batch=128,
            solver=SolverConfig(restart=40, smoother="poly"),
        )
    elif example_name == "schwinger256":
        # scale-out config: generated quenched 256^2 gauge configuration,
        # 3-level hierarchy, one device. At mass -0.10 the operator sits far
        # from criticality and the estimator stops at the minimum sample
        # count with a stderr far under the 1% target, so a deflation basis
        # buys nothing (k=0, no defl_setup) and the host CheFSI runs 3
        # rounds at degree 30.
        import jax.numpy as jnp

        return TraceConfig(
            matrix="generated:256x256:beta=5.0:seed=8",
            problem_name="schwinger",
            mass=-0.10,
            latt_dims=(256, 256),
            trace_tol=1.0e-2,
            aggrs=(8 * 8, 4 * 4),
            dof=(2, 8, 8),
            max_nr_levels=3,
            coarsest_level_directly=True,
            accuracy_mg_eigvs="low",
            test_vectors_type="RSVs",
            mlmc_levels_to_skip=(),
            nr_deflat_vctrs=0,
            defl_eigvs_tol_Hutch=1.0e-2,
            mlmc_deflat_vctrs=(0, 0),
            defl_type="exact",
            defl_eigvs_tol_MLMC=1.0e-1,
            diff_lev_op_tol=1.0e-3,
            rough_batch_full=True,
            stop_safety=0.7,
            stop_confirm=True,
            use_permuted=False,
            x_displacement=0,
            check_quality_MG=False,
            seed=51234,
            probe_batch=64,
            chebyshev_degree=30,
            subspace_iters=3,
            dtype=jnp.complex64,
            solver=SolverConfig(restart=40, smoother="poly"),
            function_tol=5.0e-4,
        )
    elif example_name == "schwinger512":
        # scale-out config: 512^2 lattice (beyond the reference's largest),
        # one device or Hutchinson probes sharded over the 'samples' mesh
        # axis when more devices exist. Same setup economics as 256^2 (k=0
        # deflation, light CheFSI): far from criticality the run stops at
        # the minimum sample count, so wall time is mostly setup time.
        # probe_batch 16 keeps the restart-40 Krylov pair buffers at
        # ~2.7 GB (40 * 16 * n * 8 B).
        import jax.numpy as jnp

        return TraceConfig(
            matrix="generated:512x512:beta=5.0:seed=9",
            problem_name="schwinger",
            mass=-0.10,
            latt_dims=(512, 512),
            trace_tol=1.0e-2,
            aggrs=(8 * 8, 4 * 4, 2 * 2),
            dof=(2, 8, 8, 8),
            max_nr_levels=4,
            coarsest_level_directly=True,
            accuracy_mg_eigvs="low",
            test_vectors_type="RSVs",
            mlmc_levels_to_skip=(),
            nr_deflat_vctrs=0,
            defl_eigvs_tol_Hutch=1.0e-2,
            mlmc_deflat_vctrs=(0, 0, 0),
            defl_type="exact",
            defl_eigvs_tol_MLMC=1.0e-1,
            diff_lev_op_tol=1.0e-3,
            rough_batch_full=True,
            stop_safety=0.7,
            stop_confirm=True,
            use_permuted=False,
            x_displacement=0,
            check_quality_MG=False,
            seed=51234,
            probe_batch=16,
            chebyshev_degree=30,
            subspace_iters=3,
            dtype=jnp.complex64,
            solver=SolverConfig(restart=40, smoother="poly"),
            function_tol=5.0e-4,
        )
    raise Exception(f"unknown experiment name {example_name!r}")


def _reference_precision() -> None:
    """The 16^2 experiments solve to the reference's 1e-12, which only
    complex128 can certify (complex64 stalls at its ~3e-7 floor): run them
    with x64 on, so the default dtype is complex128."""
    import jax

    jax.config.update("jax_enable_x64", True)


def G101():
    """Deflated Hutchinson, Schwinger 16^2 (reference: gateway.py:10-17)."""
    _reference_precision()
    cfg = set_params("schwinger16").replace(function_tol=1e-12)
    return EXAMPLE_001(cfg)


def G201():
    """Deflated MLMC, Schwinger 16^2 (reference: gateway.py:24-31)."""
    _reference_precision()
    cfg = set_params("schwinger16").replace(function_tol=1e-12)
    return EXAMPLE_002(cfg)


def G102():
    """Deflated Hutchinson, Schwinger 128^2 (reference: gateway.py:38-45).

    Runs the tuned profile (bench.py and chip_smoke.py import the same
    config)."""
    return EXAMPLE_001(set_params("schwinger128"))


def G202():
    """Deflated MLMC, Schwinger 128^2 (reference: gateway.py:52-59).

    Runs the tuned profile (same config as G102)."""
    return EXAMPLE_002(set_params("schwinger128"))


def G301():
    """Deflated Hutchinson on a generated 256^2 quenched config, one device
    (scale-out beyond the reference)."""
    return EXAMPLE_001(set_params("schwinger256"))


def G302():
    """Deflated Hutchinson on a generated 512^2 quenched config with probe
    batches sharded over all available devices.

    Multi-process: launch one process per host with
    JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID set; the
    estimator assembles the global mesh, replicates the hierarchy, shards
    probe batches globally, and gathers estimates in deterministic sample
    order on every process (tests/test_multiprocess.py proves bit-identical
    results across processes). Set DMLMC_X_SHARDS=k to additionally
    domain-decompose the 512^2 lattice over k devices per probe group
    (parallel/sharded_solve.py)."""
    import os

    import jax

    from deflatedmlmc_schwinger_tpu.io import load_operator
    from deflatedmlmc_schwinger_tpu.parallel import initialize
    from deflatedmlmc_schwinger_tpu.reporting import print_post_results, result_to_json
    from deflatedmlmc_schwinger_tpu.trace import hutchinson

    initialize()
    mesh = mesh_for(len(jax.devices()), int(os.environ.get("DMLMC_X_SHARDS", "1")))
    cfg = fit_probe_batch(set_params("schwinger512"), mesh)
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=cfg.complex_dtype())
    result = hutchinson(op, cfg, mesh=mesh)
    print_post_results(cfg, result, "hutchinson")
    print(result_to_json(cfg, result, "hutchinson"))
    return result


def mesh_for(ndev: int, x_shards: int = 1):
    """G302's mesh over ``ndev`` devices: ('samples', 'x') when ``x_shards``
    > 1 divides ndev, else all devices on 'samples'; None for one device
    (the mesh machinery is skipped entirely)."""
    from deflatedmlmc_schwinger_tpu.parallel import make_mesh

    if x_shards > 1 and ndev % x_shards == 0:
        return make_mesh((ndev // x_shards, x_shards), ("samples", "x"))
    if ndev > 1:
        return make_mesh((ndev,), ("samples",))
    return None


def fit_probe_batch(cfg: TraceConfig, mesh) -> TraceConfig:
    """Round probe_batch to a multiple of the mesh's samples axis."""
    if mesh is None:
        return cfg
    nshards = mesh.shape[cfg.sample_axis]
    if cfg.probe_batch % nshards:
        cfg = cfg.replace(probe_batch=nshards * max(1, cfg.probe_batch // nshards))
    return cfg
