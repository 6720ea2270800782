"""Smoke test of the main path on one NVIDIA GPU (or, with --four-cards, of
the 512^2 mesh path on four).

    python chip_smoke.py                # one card: numerics + G102/G202/G301
    python chip_smoke.py --four-cards   # four cards: G302 on two meshes only

Phases (one card):
  * numerics: the XLA pair stencil against the float64 host stencil at
    128^2 (B=128) and 512^2 (B=16), the depth-16 GMRES-polynomial smoother
    against a float64 host recurrence, and cplx.matmul_right at the 128^2
    hierarchy's coarsest size against float64 NumPy. Float32 on the card,
    float64 on the host; each must agree to max|err| / max|ref| <= 1e-5,
    which float32 round-off meets and TF32-rounded operands (10-bit
    mantissa, ~1e-3) would fail.
  * main path: G102 and G202 on the pinned 128^2 operator through gateway
    and trace, each to its stopping rule, checked against the pinned exact
    trace (oracles.TRACE128) to 2%: the stopping rule aims at 1% with
    stop_safety 0.7, so 2% is missed with probability below 1e-3. Then G301
    (generated 256^2, device fine-eigensolve path) to its stopping rule.

Without a GPU the script exits non-zero before any phase. The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TOL_NUMERICS = 1e-5
TOL_TRACE = 2e-2
TOL_MESH = 1e-4


def card_line() -> str:
    """The card's name and power limit, read by nvidia-smi in a child
    process (which stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def rel_err(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    print(f"{name}: max|err|/max|ref| = {err:.3e} (limit {tol:.0e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name} outside tolerance")


def _random_pair(rng, shape):
    from deflatedmlmc_schwinger_tpu.ops import cplx

    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return z.astype(np.complex128), cplx.from_complex(z)


def stencil_numerics(spec: str, mass: float, nx: int, nt: int, batch: int,
                     seed: int = 0) -> float:
    """XLA pair stencil (float32, device) against stencil_matvec_host
    (float64, host) on the float32-rounded operator and input."""
    import jax

    from deflatedmlmc_schwinger_tpu.io import load_operator
    from deflatedmlmc_schwinger_tpu.ops import cplx
    from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator, stencil_matvec_host

    op, _ = load_operator(spec, mass, latt_dims=(nt, nx), dtype=np.complex64)
    pop = pair_operator(op)
    v64, v = _random_pair(np.random.default_rng(seed), (batch, op.n))
    y = jax.jit(pop.matvec)(v)
    want = stencil_matvec_host(np.asarray(op.coeffs).astype(np.complex128), v64, nx, nt)
    return rel_err(cplx.to_complex(y), want)


def smoother_numerics(spec: str, mass: float, nx: int, nt: int, batch: int,
                      depth: int = 16, seed: int = 1) -> float:
    """Depth-``depth`` poly_smoother (float32, device) against the same
    recurrence in float64 on the host, with the roots the solver computes."""
    import jax

    from deflatedmlmc_schwinger_tpu.io import load_operator
    from deflatedmlmc_schwinger_tpu.mg.cycle import gmres_poly_roots, poly_smoother
    from deflatedmlmc_schwinger_tpu.ops import cplx
    from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator, stencil_matvec_host

    op, _ = load_operator(spec, mass, latt_dims=(nt, nx), dtype=np.complex64)
    pop = pair_operator(op)
    roots = gmres_poly_roots(jax.jit(pop.matvec), op.n, pop.dtype, depth)
    r64, r = _random_pair(np.random.default_rng(seed), (batch, op.n))
    x = jax.jit(lambda v: poly_smoother(pop.matvec, v, roots))(r)
    C = np.asarray(op.coeffs).astype(np.complex128)
    xh, cur = 0.0, r64
    for k, th in enumerate(roots):
        step = cur / th
        xh = xh + step
        if k < len(roots) - 1:
            cur = cur - stencil_matvec_host(C, step, nx, nt)
    return rel_err(cplx.to_complex(x), xh)


def matmul_numerics(n: int, batch: int, seed: int = 2) -> float:
    """cplx.matmul_right (float32, device) against float64 NumPy."""
    import jax

    from deflatedmlmc_schwinger_tpu.ops import cplx

    rng = np.random.default_rng(seed)
    a64, a = _random_pair(rng, (n, n))
    x64, x = _random_pair(rng, (batch, n))
    y = jax.jit(cplx.matmul_right)(x, a)
    return rel_err(cplx.to_complex(y), x64 @ a64.T)


def numerics_phase() -> None:
    from deflatedmlmc_schwinger_tpu import gateway, oracles

    cfg512 = gateway.set_params("schwinger512")
    check("stencil 128^2 B=128",
          stencil_numerics(oracles.SPEC128, oracles.MASS128, 128, 128, 128),
          TOL_NUMERICS)
    check("stencil 512^2 B=16",
          stencil_numerics(cfg512.matrix, cfg512.mass, 512, 512, 16),
          TOL_NUMERICS)
    check("poly_smoother depth 16, 128^2 B=128",
          smoother_numerics(oracles.SPEC128, oracles.MASS128, 128, 128, 128),
          TOL_NUMERICS)
    # coarsest size of the 128^2 hierarchy: 32768 / 32 aggregates-strips per
    # level x dof 8 -> 8192 -> 2048 -> 512
    check("matmul_right 512x512, B=128", matmul_numerics(512, 128), TOL_NUMERICS)


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def run_experiment(name: str, oracle=None) -> dict:
    """Run gateway.<name>() to its stopping rule and print its record."""
    from deflatedmlmc_schwinger_tpu import gateway

    t0 = time.time()
    r = getattr(gateway, name)()
    wall = time.time() - t0
    phases = {k: round(v, 3) for k, v in r["timer"].totals.items()}
    setup = sum(v for k, v in phases.items() if k != "sampling")
    rec = dict(
        run=name, wall_s=round(wall, 3), setup_s=round(setup, 3),
        phase_s=phases, trace=[float(np.real(r["trace"])), float(np.imag(r["trace"]))],
        nr_ests=int(r["nr_ests"]) if "nr_ests" in r else None,
        stalled_rows=int(r["stalled_rows"]), peak_bytes_in_use=peak_bytes(),
    )
    if oracle is not None:
        rec["rel_err_vs_oracle"] = abs(r["trace"] - oracle) / abs(oracle)
    print("RESULT " + json.dumps(rec), flush=True)
    if oracle is not None and not rec["rel_err_vs_oracle"] <= TOL_TRACE:
        raise SystemExit(f"{name}: realized error {rec['rel_err_vs_oracle']:.4f} "
                         f"exceeds {TOL_TRACE}")
    return rec


def main_path_phase() -> None:
    from deflatedmlmc_schwinger_tpu import oracles

    run_experiment("G102", oracles.TRACE128)
    run_experiment("G202", oracles.TRACE128)
    run_experiment("G301")


def four_card_phase(cfg=None, n_samples: int = 32) -> None:
    """G302's 512^2 Hutchinson (or ``cfg``) at a fixed sample count on a
    samples=4 mesh and on a (samples=2, x=2) mesh, each against the same
    config on one card in this process (one shared hierarchy)."""
    from deflatedmlmc_schwinger_tpu import gateway
    from deflatedmlmc_schwinger_tpu.io import load_operator
    from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy
    from deflatedmlmc_schwinger_tpu.trace import hutchinson

    cfg = (cfg or gateway.set_params("schwinger512")).replace(
        min_nr_ests=n_samples, max_nr_ests=n_samples)
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=cfg.complex_dtype())
    t0 = time.time()
    hier = setup_hierarchy(op, cfg)
    print(f"hierarchy {hier.sizes()} in {time.time() - t0:.1f} s", flush=True)

    def one(label, x_shards):
        mesh = None if x_shards is None else gateway.mesh_for(4, x_shards)
        c = gateway.fit_probe_batch(cfg, mesh)
        t = time.time()
        r = hutchinson(op, c, hier=hier, mesh=mesh, verbose=False)
        rec = dict(run=label, mesh=None if mesh is None else dict(mesh.shape),
                   wall_s=round(time.time() - t, 3), nr_ests=int(r["nr_ests"]),
                   trace=[float(np.real(r["trace"])), float(np.imag(r["trace"]))],
                   function_iters=int(r["function_iters"]),
                   stalled_rows=int(r["stalled_rows"]))
        print("RESULT " + json.dumps(rec), flush=True)
        return r

    ref = one("G302 one card", None)
    for label, xs in (("G302 samples=4", 1), ("G302 samples=2 x=2", 2)):
        r = one(label, xs)
        if r["nr_ests"] != ref["nr_ests"]:
            raise SystemExit(f"{label}: {r['nr_ests']} samples, one card "
                             f"{ref['nr_ests']}")
        check(f"{label} trace vs one card",
              abs(r["trace"] - ref["trace"]) / abs(ref["trace"]), TOL_MESH)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card G302 mesh phase")
    args = ap.parse_args()

    print(f"card: {card_line()}", flush=True)
    import jax

    devs = jax.devices()
    print(f"jax {jax.__version__}: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}", flush=True)
    if devs[0].platform != "gpu":
        print("no GPU visible to JAX; nothing was run", file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devs) < want:
        print(f"needs {want} GPUs, JAX sees {len(devs)}", file=sys.stderr)
        return 2

    from deflatedmlmc_schwinger_tpu.utils import jaxcache

    jaxcache.enable()
    t0 = time.time()
    if args.four_cards:
        four_card_phase()
    else:
        numerics_phase()
        main_path_phase()
    print(f"all phases passed in {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
