"""Device mesh + sharding helpers (SURVEY.md section 2.3).

The primary parallel axis is 'samples' (probe data-parallelism, P1): probe
batches shard over it and every solve in the batched Krylov stack is
independent along the batch dimension, so GSPMD partitions the whole
estimator step with no code changes -- the only cross-sample communication
XLA inserts is the tiny all-reduce for the convergence predicates and, at the
end, the moment reduction.

The secondary axis is 'x' (lattice domain decomposition, P3): grid-form
fields (..., 2, X, T) shard along X; the stencil's jnp.roll becomes a halo
exchange (collective-permute) inserted by XLA.

Probes are counter-based (trace/probes.py), so estimates are bit-identical
across mesh shapes -- the mesh-invariance tests rely on this.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("samples",),
    devices=None,
) -> Mesh:
    """Create a device mesh; defaults to all devices on one 'samples' axis."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def spans_processes(mesh: Mesh) -> bool:
    """True when the mesh has devices owned by other processes (multi-host);
    global arrays must then be built shard-by-shard from local host values."""
    me = jax.process_index()
    return any(d.process_index != me for d in np.asarray(mesh.devices).flat)


def shard_batch(x, mesh: Mesh, axis: str = "samples"):
    """Place a (B, ...) array (or CP pair) with its leading dim sharded over
    ``axis``. Works on single- and multi-process meshes (probes are
    counter-keyed, so every process holds the identical host batch)."""
    from deflatedmlmc_schwinger_tpu.ops.cplx import CP

    if spans_processes(mesh):
        from deflatedmlmc_schwinger_tpu.parallel.distributed import (
            shard_global_batch,
        )

        return shard_global_batch(x, mesh, axis)
    nd = x.re.ndim if isinstance(x, CP) else x.ndim
    spec = P(axis, *([None] * (nd - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (hierarchy, deflation basis) across the mesh
    (SURVEY.md P4: setup artifacts broadcast to every chip/host)."""
    sharding = NamedSharding(mesh, P())
    if spans_processes(mesh):
        def put(a):
            host = np.asarray(a)
            return jax.make_array_from_callback(
                host.shape, sharding, lambda idx: host[idx]
            )
    else:
        def put(a):
            return jax.device_put(a, sharding)
    return jax.tree_util.tree_map(put, tree)
