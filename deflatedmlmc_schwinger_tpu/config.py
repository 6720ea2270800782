"""Typed configuration for the trace estimators and the multigrid solver.

Mirrors the full parameter surface of the reference's ``set_params`` /
``trace_params_from_params`` (reference: gateway.py:63-169, utils.py:73-125),
plus device knobs (dtype, probe batch size, mesh axes, Krylov sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from deflatedmlmc_schwinger_tpu import oracles


def default_complex_dtype():
    """complex128 when x64 is enabled (CPU validation), else complex64."""
    import jax

    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


@dataclasses.dataclass
class SolverConfig:
    """Knobs for the multigrid-preconditioned FGMRES solver.

    The reference solves with pyamg fgmres (maxiter<=1000) preconditioned by a
    V-cycle whose smoother is a 2-iteration scipy ``lgmres``
    (reference: multigrid.py:347-447). Here the smoother is a fixed
    ``smooth_iters``-step GMRES (jitted, batched) and FGMRES uses fixed-size
    Krylov buffers of length ``restart`` with at most ``max_restarts`` cycles.
    """

    restart: int = 20
    max_restarts: int = 10
    # on 16^2/128^2: 4 smoothing steps halve the outer FGMRES
    # iteration count vs the reference's nominal 2, for the same total
    # fine-level matvec work but half the V-cycle/coarse-solve overhead
    smooth_iters: int = 4
    # 'gmres': adaptive fixed-step GMRES smoothing (reference semantics);
    # 'poly': fixed GMRES-residual-polynomial smoothing (same matvec count,
    # ZERO inner products -- ~7x fewer ops per V-cycle; roots computed once
    # per level at setup)
    smoother: str = "gmres"
    # Stagnation cutoff: stop after ``stall_cycles`` consecutive restart
    # cycles with no active row improving by >(1 - stall_ratio); None
    # disables it (exact-parity validation runs). Rows that end above tol
    # are flagged in FGMRESResult.stalled.
    stall_ratio: Optional[float] = 0.9
    stall_cycles: int = 2
    # Residual tolerance floor; requested tolerances are clipped to
    # max(tol, tol_floor(dtype)). complex64 cannot certify 1e-12 residuals.
    # The trace BIAS introduced by the f32 floor is bounded by
    # tests/test_bias.py: on 16^2, Hutchinson/MLMC traces computed with
    # f32-floor solve tolerances agree with the f64 dense oracle to well
    # under the 1% trace budget (see that test for the measured bound).
    tol_floor_c64: float = 3.0e-7
    tol_floor_c128: float = 1.0e-13

    def tol_floor(self, dtype) -> float:
        return self.tol_floor_c128 if jnp.dtype(dtype) == jnp.complex128 else self.tol_floor_c64

    def effective_tol(self, tol: float, dtype) -> float:
        return max(float(tol), self.tol_floor(dtype))


@dataclasses.dataclass
class TraceConfig:
    """Full configuration of one trace-estimation experiment.

    Field-for-field parity with the reference's params dict
    (gateway.py:63-169); device additions at the bottom.
    """

    # ---- problem / matrix (reference: matrix.py:14-31) ----
    matrix: str = oracles.SPEC128
    problem_name: str = "schwinger"
    mass: float = oracles.MASS128
    latt_dims: Tuple[int, int] = (128, 128)  # (nt, nx)

    # ---- trace estimation ----
    trace_tol: float = 1.0e-2           # relative stopping tolerance
    function_tol: float = 1.0e-12       # linear-solve tolerance (clipped per dtype)
    max_nr_ests: int = 100000           # utils.py:81,108
    min_nr_ests: int = 6                # stop rule needs i>=5 (stoch_trace.py:153)
    nr_rough_iters: int = 5             # stoch_trace.py:104
    # The rough-trace batch is padded to probe_batch so its XLA program equals
    # the sampling program (one compile); with rough_batch_full the estimators
    # average over ALL padded probes instead of the reference's 5
    # (stoch_trace.py:104) -- the same batch's cost, a far tighter stopping
    # target |trace_tol * rough_trace| (the 5-probe rough of the 128^2
    # flagship scatters by +-75%, making "1%" stops land anywhere between
    # 0.5% and 4% actual error). Default False = reference parity.
    rough_batch_full: bool = False
    rough_seed: int = 123456            # stoch_trace.py:103
    seed: int = 51234                   # gateway.py:67,106 (probe stream)
    # Stopping safety factor: sampling stops when the standard error drops
    # below stop_safety * |trace_tol * rough_trace|.  1.0 = reference parity
    # (stoch_trace.py:118,147-154) -- but a target sitting exactly at the
    # tolerance means the REALIZED |error| exceeds it whenever the estimate
    # draws >~1 sigma: for a complex-Gaussian estimate the miss probability
    # is P(|err| > tol) = exp(-(tol/stderr)^2), i.e. 37% at 1.0, 21% at 0.8
    # (~56% sample surcharge), 13% at 0.7 (~2x surcharge), ~6% at 0.6
    # (~2.8x surcharge).  This tail is a property of the final stderr alone
    # -- no stopping-rule cleverness changes it -- so the safety factor is
    # the one honest knob; the tuned 128^2 config ships 0.7 + stop_confirm
    # (below), and chip_smoke.py checks the realized error against the
    # pinned oracle.
    stop_safety: float = 1.0
    # Two-pass stopping confirmation (trace/stats.py ConfirmedStop): stop
    # only when the stderr condition holds on two checks separated by >= 1
    # batch. Guards against stopping on a transiently UNDERESTIMATED
    # std_dev (the n-sample deviation has O(1/sqrt(n)) relative noise --
    # at the flagship's n~30k that noise is ~0.4%, at a 16^2 run's n~100
    # it is ~7% and a lucky batch can stop the run a factor early). It
    # does NOT shrink the Rayleigh tail of the realized error (see
    # stop_safety); surcharge is at most one extra batch.
    stop_confirm: bool = False

    # ---- multigrid hierarchy (reference: multigrid.py:100-344) ----
    max_nr_levels: int = 4
    aggrs: Sequence[int] = (4 * 4, 2 * 2, 2 * 2)
    dof: Sequence[int] = (2, 8, 8, 8)
    accuracy_mg_eigvs: str = "high"     # 'low' -> 1e-3 | 'high' -> 1e-9
    test_vectors_type: str = "EVs"      # {'EVs','LSVs','RSVs'}
    check_quality_MG: bool = False
    coarsest_level_directly: bool = True

    # ---- deflation ----
    nr_deflat_vctrs: int = 8            # Hutchinson deflation basis size
    mlmc_deflat_vctrs: Sequence[int] = (0, 0, 0)
    defl_type: str = "exact"            # {'exact','inexact_01','inexact_03'}
    defl_eigvs_tol_Hutch: float = 1.0e-9
    defl_eigvs_tol_MLMC: float = 1.0e-1
    diff_lev_op_tol: float = 1.0e-3
    # Inverse-subspace-iteration rounds for the Hutchinson deflation basis.
    # NOTE defl_eigvs_tol_Hutch doubles as the MG solve tolerance inside the
    # iteration (reference semantics, utils.py:141-142); loosening it cuts
    # the basis setup by a large factor, and the correction_mode='solve' tr1
    # is exact for any basis, so a loose basis costs only variance, not
    # bias.
    defl_subspace_rounds: int = 6
    # Chebyshev warm-start for the Hutchinson deflation basis: degree of ONE
    # device filter pass (in lambda^2) applied to the random start block
    # before the first inverse-iteration round; 0 disables. Found
    # counterproductive at 128^2: the filtered block hands the first inverse
    # round near-kernel-saturated right-hand sides, whose MG solves run to
    # the stall cutoff, and the resulting basis gave a worse per-probe
    # deviation (74-87 vs 69). With an MG-driven inverse iteration
    # available, plain random starts + one fewer round dominate; the knob
    # remains for operators with no usable solver (where a filter pass is
    # the only spectral boost).
    defl_warm_filter_degree: int = 0
    # Subspace buffer size m (None -> max(k+2, 1.25k)). Setting it equal to
    # probe_batch makes every deflation-setup solve reuse the SAMPLING
    # batch's XLA program -- no extra compile per distinct batch shape. The
    # correction solves pad to probe_batch for the same reason.
    # NOTE buffer == k leaves zero guard vectors in the inverse subspace
    # iteration (edge Ritz pairs converge slower than with the default
    # max(k+2, 1.25k) buffer); the tuned 128^2 config accepts that: a sweep
    # gave identical per-probe deviation with buffer=k=128 vs buffer=160,
    # and the exact 'solve' correction keeps tr1 unbiased for any basis
    # quality.
    defl_buffer: Optional[int] = None
    # MLMC only: deflation basis size / inverse-iteration rounds for the
    # ROUGH-trace phase (mlmc's rough trace builds its own Hutchinson-style
    # basis, reference stoch_trace.py:281-302). None -> nr_deflat_vctrs /
    # defl_subspace_rounds. The rough trace only sets the stopping-rule
    # denominator |trace_tol * rough_trace|, so a cheaper basis (fewer
    # rounds) is fine there while the Hutchinson estimator itself wants the
    # full-quality basis.
    rough_deflat_vctrs: Optional[int] = None
    rough_defl_rounds: Optional[int] = None
    # f64 iterative-refinement steps for the deflation CORRECTION solves
    # (correction_mode='solve' and the MLMC fine-deflation add-back). The
    # correction right-hand sides are the deflation vectors themselves --
    # the worst-conditioned systems in the run -- and an f32 solve at
    # relative residual r can in principle leave a SOLUTION error up to
    # ~r/sigma_min per vector. Each step recomputes the residual of the
    # accumulated f64 solution EXACTLY on the host (ops/dirac.py
    # stencil_matvec_host) and adds one more f32 device solve, collapsing
    # the worst case to O(r^2/sigma_min). At the 128^2 config's 5e-4 target
    # the unrefined tr1 was already accurate -- refinement moved the trace
    # by <1e-3 while its residual re-solves (low-mode-rich) ran to the stall
    # cutoff (tests/test_refine.py bounds the 16^2/f32 case). So the
    # default is OFF; enable (1-2 steps) for contracts tighter than the 1%
    # budget or solve targets much looser than 5e-4.
    defl_refine_steps: int = 0

    # ---- MLMC ----
    mlmc_levels_to_skip: Sequence[int] = (1,)
    # Difference-level scheduling (SURVEY.md P2):
    #   'sequential' -- reference parity: each level sampled to its own share
    #     of the tolerance budget, one level after another
    #     (stoch_trace.py:327-416);
    #   'adaptive'  -- optimal MLMC allocation: levels are sampled in
    #     interleaved batches, each batch going to the level with the largest
    #     marginal variance reduction per unit cost, until the AGGREGATE
    #     stderr sum_l V_l/n_l meets the total budget. Strictly cheaper than
    #     fixed splits when level variances/costs are unbalanced.
    mlmc_schedule: str = "sequential"
    # MLMC extensions (both OFF by default = reference parity,
    # reference: stoch_trace.py:348-437):
    #
    # Difference levels whose FINE size n_l is <= this cutoff are computed
    # EXACTLY (dense f64 inverses on the host + the accumulated B-block),
    # generalizing the reference's exact-coarsest rule to every level small
    # enough for dense linear algebra. Rationale: the f32 iterative
    # coarse-level solves floor at ~1e-2 relative residual
    # (eps32 * kappa of the Galerkin coarse operators -- they are MORE
    # ill-conditioned than the fine level), so sampling those levels in f32
    # is bias-limited, while computing them densely is exact, removes their
    # variance entirely, and frees the whole stochastic budget for the big
    # levels. Sampled levels whose COARSE operator falls under the cutoff
    # apply a precomputed f64->f32 dense inverse (one matmul) instead of an
    # iterative solve (accurate: one matmul has no kappa-amplified
    # iteration floor).
    mlmc_exact_dense_max_n: int = 0
    # Deflate the LEVEL-0 difference probes with the Hutchinson gamma3
    # deflation basis (the basis the rough-trace phase already builds)
    # instead of the reference's difference-operator eigenvectors. The
    # projector removes the near-critical modes from the probe BEFORE the
    # solve, which cuts both the true difference variance and the f32 solve
    # noise (an undeflated solution has norm ~1/|lambda_min|, so even a
    # 5e-4-relative solve error scatters estimates by O(100) -- a
    # per-probe deviation of 841 undeflated at 128^2). The removed subspace is added back
    # EXACTLY with one extra batch: tr(M_0 U U^H) = sum_i <U_i, M_0 U_i>,
    # where M_0 is the full level-0 difference map -- exact for any basis
    # quality, like correction_mode='solve'. Mutually exclusive with
    # mlmc_deflat_vctrs[0] > 0.
    mlmc_fine_deflation: bool = False

    # ---- displaced trace tr(D^-1 Pi) (reference: multigrid.py:141-155) ----
    use_permuted: bool = True
    x_displacement: int = 2

    # ---- device knobs ----
    probe_batch: int = 8                # probes per device per batch
    dtype: Optional[object] = None      # complex dtype; None -> per-x64 default
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    # Separate solver profile for the deflation BASIS solves (inverse
    # iteration at defl_eigvs_tol_Hutch; the tr1 correction solves at
    # function_tol always use `solver`); None -> use `solver`. Why it exists: the sampling
    # profile is tuned for throughput on DEFLATED probes (a deep smoother
    # cuts outer iterations), but deflation solves near-kernel right-hand
    # sides that run into the stall cutoff -- fixed-iteration-count work
    # whose cost scales with per-iteration price, so a deep smoother makes
    # defl_setup dearer. A shallow profile here keeps the sampling profile
    # from paying that at setup.
    defl_solver: Optional[SolverConfig] = None
    # coarse operator storage: 'auto' packs intermediate levels as cyclic
    # block stencils when the coupling pattern is small (hierarchy.py),
    # 'dense' forces dense matrices (the coarsest is always dense -- its
    # inverse is precomputed)
    coarse_format: str = "auto"
    # where the one-time hierarchy setup runs: 'host' (numpy/scipy, see
    # mg/host_setup.py; setup is a few GFLOPs and compiles no programs) or
    # 'device' (CheFSI/Galerkin on the accelerator; for lattices whose fine
    # matvec is too large for host numpy)
    setup_backend: str = "host"
    # Where the FINE-level test-vector eigensolve runs when
    # setup_backend='host': 'host' (numpy CheFSI), 'device' (the
    # device-resident CheFSI of solvers/eigs.py -- vectors stay on the
    # accelerator, one (n, m) download at the end), or 'auto' = device for
    # lattices with n >= 2^17 and RSVs/LSVs test vectors. Rationale: the
    # single-threaded host recurrence dominates set-up on large lattices,
    # where the device filter runs the same matvecs after ~5 one-time
    # compiles; below the threshold the host path avoids those compiles.
    setup_fine_eigs: str = "auto"
    # eigensolver effort for setup (Chebyshev-filtered subspace iteration);
    # coarse levels warm-start from the restricted fine test vectors and
    # need fewer rounds (None -> max(2, subspace_iters // 2))
    chebyshev_degree: int = 100
    subspace_iters: int = 8
    subspace_iters_coarse: Optional[int] = None
    # Stalled-solve policy: FGMRES flags rows whose final residual never
    # reached tol (the stall cutoff stops hopeless restarts,
    # SolverConfig.stall_ratio).  Estimates from under-solved probes are
    # BIASED, so the estimators count stalled rows per batch, report the
    # total in the result ('stalled_rows'), and raise as soon as the running
    # stalled fraction exceeds this threshold -- silently folding a
    # systematically hard batch into the trace is the one failure the
    # reference (which solves to 1e-12 unconditionally, gateway.py:148)
    # cannot have, so ours must be loud about it.  The default tolerates the
    # occasional unlucky probe (isolated stalls land within ~tol of the
    # requested residual and perturb the trace well under the stopping
    # noise) while any systematic pathology trips the error within a batch.
    max_stalled_frac: float = 0.05
    # mesh axis name for sample data-parallelism
    sample_axis: str = "samples"
    # mesh axis name for lattice domain decomposition (fine-level solves run
    # the shard_map SPMD program when the mesh carries this axis with size>1)
    lattice_axis: str = "x"

    def complex_dtype(self):
        return self.dtype if self.dtype is not None else default_complex_dtype()

    @property
    def nt(self) -> int:
        return int(self.latt_dims[0])

    @property
    def nx(self) -> int:
        return int(self.latt_dims[1])

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)
