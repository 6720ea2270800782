"""Result reporting (reference: utils.py:36-69 print_post_results)."""

from __future__ import annotations

import json
from typing import Dict

from deflatedmlmc_schwinger_tpu.config import TraceConfig


def print_post_results(cfg: TraceConfig, result: Dict, example: str) -> None:
    if example == "mlmc":
        print(" -- matrix : " + cfg.matrix)
        n = 2 * cfg.nt * cfg.nx
        print(f" -- matrix size : {n}x{n}")
        print(" -- tr(A^{-1}) = " + str(result["trace"]))
        print(f" -- total MG complexity = {result['total_complexity']/1e6} MFLOPS")
        print(" -- std dev = ---")
        for i in range(result["nr_levels"]):
            r = result["results"][i]
            print(" -- level : " + str(i))
            print(" \t-- number of estimates = " + str(r["nr_ests"]))
            print(" \t-- function iters = " + str(r["function_iters"]))
            print(" \t-- trace = " + str(r["ests_avg"]))
            print(" \t-- std dev = " + str(r["ests_dev"]))
            print(" \t-- var = " + str(r["ests_dev"] * r["ests_dev"]))
            print(f"\t-- level MG complexity = {r['level_complexity']/1e6} MFLOPS")
    elif example == "hutchinson":
        print(" -- matrix : " + cfg.matrix)
        n = 2 * cfg.nt * cfg.nx
        print(f" -- matrix size : {n}x{n}")
        print(" -- tr(A^{-1}) = " + str(result["trace"]))
        print(f" -- total MG complexity = {result['total_complexity']/1e6} MFLOPS")
        print(" -- std dev = " + str(result["std_dev"]))
        print(" -- var = " + str(result["std_dev"] * result["std_dev"]))
        print(" -- number of estimates = " + str(result["nr_ests"]))
        print(" -- function iters = " + str(result["function_iters"]))
    else:
        raise Exception("Value for parameter <example> not available.")


def result_to_json(cfg: TraceConfig, result: Dict, example: str) -> str:
    """Structured (JSON-lines) metrics of one run."""
    out = dict(
        example=example,
        matrix=cfg.matrix,
        trace_re=float(result["trace"].real),
        trace_im=float(result["trace"].imag),
        total_complexity=float(result["total_complexity"]),
    )
    if "stalled_rows" in result:
        out["stalled_rows"] = int(result["stalled_rows"])
    if example == "hutchinson":
        out.update(
            std_dev=float(result["std_dev"]),
            nr_ests=int(result["nr_ests"]),
            function_iters=int(result["function_iters"]),
        )
    else:
        out["levels"] = [
            dict(
                nr_ests=int(r["nr_ests"]),
                function_iters=int(r["function_iters"]),
                trace_re=float(complex(r["ests_avg"]).real),
                trace_im=float(complex(r["ests_avg"]).imag),
                std_dev=float(r["ests_dev"]),
                level_complexity=float(r["level_complexity"]),
                stalled_rows=int(r.get("stalled_rows", 0)),
            )
            for r in result["results"]
        ]
    if "timer" in result:
        out["phase_seconds"] = {k: round(v, 4) for k, v in result["timer"].totals.items()}
    return json.dumps(out)
