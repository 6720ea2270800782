"""Device profiling hooks (SURVEY.md section 5.1: the reference's
CustomTimer + print spans become jax.profiler traces with named scopes;
PhaseTimer covers the host-visible wall clocks).

Set DMLMC_PROFILE=<dir> to capture a device trace of any entry point
(viewable with TensorBoard or Perfetto); ``named_scope`` annotates estimator
phases inside the trace.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext


def named_scope(name: str):
    """jax.named_scope passthrough (safe to use unconditionally)."""
    import jax

    return jax.named_scope(name)


@contextmanager
def maybe_trace(default_dir: str | None = None):
    """Profile the enclosed region to $DMLMC_PROFILE (or ``default_dir``);
    no-op when neither is set."""
    import jax

    trace_dir = os.environ.get("DMLMC_PROFILE", default_dir or "")
    ctx = jax.profiler.trace(trace_dir) if trace_dir else nullcontext()
    with ctx:
        yield
