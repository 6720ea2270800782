"""Deflated Hutchinson trace estimator (reference: stoch_trace.py:33-179).

Pipeline parity:
  MG setup -> deflation precompute -> 5-probe rough trace -> main probe loop
  with the stderr-based stopping rule -> result dict with the analytic
  complexity model.

Changes from the reference:
  * probes are sampled in batches of ``cfg.probe_batch`` and solved as one
    batched MG-FGMRES call (the reference runs one 10-second solve per probe
    on one core; here the whole batch shares every V-cycle);
  * all device compute is in (re, im) pair form (ops/cplx.py);
  * probes come from counter-based keys (order/batch/shard independent) or,
    for matched-seed validation, from the reference's exact NumPy stream
    (trace/probes.py);
  * the stopping rule is evaluated after each batch on merged running
    moments, preserving the reference's statistical contract (stderr <
    tol * |rough_trace|, n >= 6) at worst one batch of oversampling.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from deflatedmlmc_schwinger_tpu.config import TraceConfig
from deflatedmlmc_schwinger_tpu.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu.mg.setup import setup_hierarchy
from deflatedmlmc_schwinger_tpu.ops import cplx
from deflatedmlmc_schwinger_tpu.ops.stencil_kernel import plain_under_mesh
from deflatedmlmc_schwinger_tpu.ops.dirac import (
    StencilOperator,
    pair_operator,
    shift_rows_down_pair,
)
from deflatedmlmc_schwinger_tpu.trace.deflation import (
    Deflation,
    deflate,
    hutchinson_deflation,
)
from deflatedmlmc_schwinger_tpu.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu.trace.stats import (
    ConfirmedStop,
    RunningMoments,
    check_stalled,
    should_stop,
)
from deflatedmlmc_schwinger_tpu.utils.flops import flops_vcycle, level_nnz
from deflatedmlmc_schwinger_tpu.utils.timer import PhaseTimer


def hutchinson_step_batch(op, solver: MGSolver, cfg: TraceConfig,
                          defl: Deflation, probes, fine_solver=None,
                          gather: bool = True):
    """One batch of deflated Hutchinson estimates (reference:
    utils.py:210-250). probes is a (B, n) CP pair; returns host
    (estimates complex (B,), per-row iteration counts, per-row stalled
    flags), or -- with ``gather=False`` -- the same three as DEVICE values
    for the device-resident stopping path (trace/stats.py).

    ``fine_solver``: optional solver for the fine-level systems -- the
    lattice-sharded ShardedMGSolver when running on a ('samples', 'x') mesh
    (parallel/sharded_solve.py); defaults to the replicated MGSolver."""
    x = probes
    x_def = deflate(x, defl.U)
    d = solver.hier.levels[0].perm_shift
    if cfg.use_permuted and d:
        x_def = shift_rows_down_pair(x_def, d)
    res = (fine_solver or solver).solve(x_def, cfg.function_tol)
    e = cplx.cdot(x, res.x)                  # (B,) pair
    if not gather:
        return e, res.iters, res.stalled
    # global_values assembles the full batch on every process (multi-host
    # runs shard the batch across processes; single-process it is asarray),
    # so moments and stopping decisions are identical everywhere
    from deflatedmlmc_schwinger_tpu.parallel.distributed import global_values

    return (
        global_values(e.re) + 1j * global_values(e.im),
        global_values(res.iters),
        global_values(res.stalled),
    )


@plain_under_mesh
def hutchinson(
    op,
    cfg: TraceConfig,
    *,
    hier=None,
    solver: Optional[MGSolver] = None,
    probe_source: str = "jax",
    timer: Optional[PhaseTimer] = None,
    verbose: bool = True,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
) -> Dict:
    """Compute tr(A^{-1}) (or tr(A^{-1} Pi)) by deflated Hutchinson.

    ``checkpoint_dir``: if set, the hierarchy is cached there and the
    sampling state (moments + next sample index) persists after every batch;
    an interrupted run resumes on the exact same counter-keyed probe stream
    (utils/checkpoint.py).

    If ``mesh`` is given, each probe batch is sharded over its 'samples' axis
    (probe data-parallelism, SURVEY.md P1) -- results are bit-identical to the
    unsharded run thanks to counter-based probe keys."""
    timer = timer or PhaseTimer()
    log = print if verbose else (lambda *a, **k: None)
    # keep the host-side operator for setup: setup_backend='host' reads the
    # coefficient tensor on the host, so it need not come back off the device
    op_for_setup = op
    if isinstance(op, StencilOperator):
        op = pair_operator(op)

    # ---- MG setup (stoch_trace.py:50-75) ----
    hier_ckpt = None
    state_ckpt = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        hier_ckpt = os.path.join(checkpoint_dir, "hierarchy.npz")
        state_ckpt = os.path.join(checkpoint_dir, "hutchinson_state.json")
    if solver is None:
        with timer.phase("mg_setup"):
            if hier is None:
                if hier_ckpt and os.path.exists(hier_ckpt):
                    from deflatedmlmc_schwinger_tpu.utils.checkpoint import load_hierarchy

                    hier = load_hierarchy(hier_ckpt, op.dtype)
                    log(f"resumed hierarchy from {hier_ckpt}")
                else:
                    hier = setup_hierarchy(op_for_setup, cfg)
                    if hier_ckpt:
                        from deflatedmlmc_schwinger_tpu.utils.checkpoint import save_hierarchy

                        save_hierarchy(hier, hier_ckpt)
            solver = MGSolver(hier, cfg.solver)
    else:
        hier = solver.hier
    if hier.nr_levels < 3:
        raise Exception("the estimator needs a hierarchy of at least three levels")
    log(f"MG hierarchy sizes: {hier.sizes()}")

    # multi-host (SURVEY.md P5): a mesh spanning several processes needs the
    # hierarchy as GLOBAL replicated arrays (closures over process-local
    # arrays cannot feed a global computation); single-process meshes skip
    # this, GSPMD handles local constants
    if mesh is not None:
        from deflatedmlmc_schwinger_tpu.parallel import replicate
        from deflatedmlmc_schwinger_tpu.parallel.mesh import spans_processes

        if spans_processes(mesh):
            hier = replicate(hier, mesh)
            solver = MGSolver(hier, solver.cfg)

    # lattice domain decomposition (SURVEY.md P3): when the mesh carries a
    # lattice axis, every fine-level probe solve runs the sharded SPMD
    # program (halo-exchange stencil, shard-local P/R, psum'd Krylov dots)
    fine_solver = None
    if (
        mesh is not None
        and cfg.lattice_axis in mesh.axis_names
        and mesh.shape[cfg.lattice_axis] > 1
    ):
        from deflatedmlmc_schwinger_tpu.parallel.sharded_solve import ShardedMGSolver

        fine_solver = ShardedMGSolver(
            hier, mesh, cfg.solver,
            x_axis=cfg.lattice_axis, sample_axis=cfg.sample_axis,
        )
        log(f"fine-level solves lattice-sharded over "
            f"{mesh.shape[cfg.lattice_axis]} '{cfg.lattice_axis}' shards")

    # ---- deflation precompute (stoch_trace.py:79-95) ----
    with timer.phase("defl_setup"):
        defl = hutchinson_deflation(op, solver, cfg, fine_solver=fine_solver)
        if mesh is not None and defl.U is not None:
            from deflatedmlmc_schwinger_tpu.trace.deflation import replicate_deflation

            defl = replicate_deflation(defl, mesh)
    if defl.values is not None:
        log(f"deflation |eigs|: {np.abs(defl.values)}  tr1={defl.tr1:.6f}")

    # ---- rough trace (stoch_trace.py:101-118) ----
    rough_probes = make_probe_source(probe_source, cfg.rough_seed)
    n = op.n
    rdtype = op.dtype
    with timer.phase("rough_trace"):
        # pad the 5-probe rough batch to the sampling batch size: the XLA
        # program is then IDENTICAL to the main loop's (one compile total);
        # only the first nr_rough_iters estimates enter the statistic
        Br = max(int(cfg.nr_rough_iters), int(cfg.probe_batch))
        X = rough_probes(0, Br, n, rdtype)
        es, _, stall = hutchinson_step_batch(op, solver, cfg, defl, X, fine_solver)
        n_rough = Br if cfg.rough_batch_full else int(cfg.nr_rough_iters)
        rough_trace = complex(np.mean(es[:n_rough])) + defl.tr1
    stalled_rows = int(np.sum(stall))
    check_stalled(stalled_rows, Br, cfg.max_stalled_frac, "hutchinson rough trace")
    # stop_safety < 1 tightens the stopping target below the named tolerance
    # so the realized error meets the contract with margin (config.py)
    rough_trace_tol = cfg.stop_safety * abs(cfg.trace_tol * rough_trace)
    log(f"rough trace: {rough_trace:.6f}  target stderr: {rough_trace_tol:.3e}")

    # ---- main loop (stoch_trace.py:131-154) ----
    from deflatedmlmc_schwinger_tpu.utils.checkpoint import EstimatorState

    probes = make_probe_source(probe_source, cfg.seed)
    state = EstimatorState.load_or_empty(state_ckpt)
    moments = state.moments.get("hutchinson", RunningMoments())
    resume_at = state.next_index.get("hutchinson", 0)
    if resume_at:
        log(f"resuming sampling at sample {resume_at} (n={moments.count})")
    function_iters = int(state.iters.get("hutchinson", 0))
    solver.coarsest_lev_iters[0] = 0
    if fine_solver is not None:
        fine_solver.coarsest_lev_iters[0] = 0
    B = int(cfg.probe_batch)
    if mesh is not None:
        from deflatedmlmc_schwinger_tpu.parallel import shard_batch

        nshards = mesh.shape[cfg.sample_axis]
        if B % nshards:
            raise ValueError(f"probe_batch {B} not divisible by mesh axis {nshards}")
    # device-resident stopping state (SURVEY.md section 5.8 item (d)): on the
    # single-process non-checkpointing path the moments live on device and
    # only a stop bool crosses the host link per batch; checkpointing and
    # multi-process runs need the estimates host-side anyway and keep the
    # gathered path
    use_device_stats = state_ckpt is None and mesh is None
    with timer.phase("sampling"):
        start = resume_at
        if use_device_stats:
            import jax

            import jax.numpy as jnp

            from deflatedmlmc_schwinger_tpu.trace.stats import (
                device_moments_init,
                device_moments_to_host,
                device_moments_update,
                device_stop_and_stalled,
            )

            dm = device_moments_init(rdtype)
            stall_acc = jnp.zeros((), jnp.int32)
            upd = jax.jit(device_moments_update)
            flag_fn = jax.jit(device_stop_and_stalled)
            # the [stop, stalled] flags are read TWO batches late: batches
            # i+1 and i+2 are already dispatched while flags i travel to the
            # host, so the device has queued work while the host waits on a
            # fetch. Worst case is two extra batches of samples folded into
            # the moments -- the stopping contract (stderr < tol at the
            # reported n) still holds.
            inflight = []
            stopper = ConfirmedStop(cfg.stop_confirm)
            while start < cfg.max_nr_ests:
                X = probes(start, B, n, rdtype)
                e, iters, stall = hutchinson_step_batch(
                    op, solver, cfg, defl, X, fine_solver, gather=False
                )
                dm = upd(dm, e.re, e.im, iters)
                stall_acc = stall_acc + jnp.sum(stall).astype(jnp.int32)
                start += B
                inflight.append(
                    (start, flag_fn(dm, rough_trace_tol, cfg.min_nr_ests,
                                    stall_acc))
                )
                if len(inflight) > 2:
                    seen, flag = inflight.pop(0)
                    stop, nstall = (int(v) for v in np.asarray(flag))
                    check_stalled(nstall, seen - resume_at,
                                  cfg.max_stalled_frac, "hutchinson sampling")
                    # consecutive fetched flags are one batch apart, so the
                    # confirmation guard sees exactly the two-pass contract
                    if stopper(bool(stop), seen):
                        break
            moments = moments.merge(device_moments_to_host(dm))
            function_iters += int(np.asarray(dm.iters))
            nstall = int(np.asarray(stall_acc))
            check_stalled(nstall, start - resume_at, cfg.max_stalled_frac,
                          "hutchinson sampling")
            stalled_rows += nstall
        else:
            stopper = ConfirmedStop(cfg.stop_confirm)
            while start < cfg.max_nr_ests:
                X = probes(start, B, n, rdtype)
                if mesh is not None:
                    X = shard_batch(X, mesh, cfg.sample_axis)
                es, iters, stall = hutchinson_step_batch(
                    op, solver, cfg, defl, X, fine_solver
                )
                moments.update_batch(es)
                function_iters += int(np.sum(iters))
                stalled_rows += int(np.sum(stall))
                start += B
                check_stalled(stalled_rows, start - resume_at + Br,
                              cfg.max_stalled_frac, "hutchinson sampling")
                if state_ckpt:
                    EstimatorState(
                        moments={"hutchinson": moments},
                        next_index={"hutchinson": start},
                        iters={"hutchinson": function_iters},
                    ).save(state_ckpt)
                if stopper(
                    should_stop(moments, rough_trace_tol, cfg.min_nr_ests),
                    moments.count,
                ):
                    break

    # ---- results (stoch_trace.py:165-176) ----
    nnz = level_nnz(hier)
    result = dict(
        trace=moments.mean + defl.tr1,
        std_dev=moments.std_dev,
        nr_ests=moments.count,
        function_iters=function_iters,
        rough_trace=rough_trace,
        stalled_rows=stalled_rows + defl.stalled_rows,
    )
    total = flops_vcycle(nnz, solver.cfg.smooth_iters, 0, 0) * function_iters
    total += nnz[-1] * int(solver.coarsest_lev_iters[0])
    if fine_solver is not None:
        total += nnz[-1] * int(fine_solver.coarsest_lev_iters[0])
    k = int(cfg.nr_deflat_vctrs)
    # reference's deflation-work fudge (stoch_trace.py:174-175)
    total += moments.count * (2.0 * n * k) / 3.0
    result["total_complexity"] = total
    result["timer"] = timer
    return result
