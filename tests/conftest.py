"""Test harness configuration.

Tests run on CPU with 8 virtual devices (the standard JAX trick for testing
multi-device sharding without hardware) and with x64 enabled so complex128
matches the SciPy host oracles bit-for-bit in structure.

Tests marked ``gpu`` need the card: they take the ``gpu`` fixture, which
skips them on the CPU. Run them on a machine with a GPU, in one process
(JAX_PLATFORMS=cuda python -m pytest -p no:xdist -m gpu tests/), since each
JAX process reserves most of the card's memory.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# The suite runs on the CPU unless JAX_PLATFORMS names another backend
# (the gpu-marked tests are run that way on the card).
if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from deflatedmlmc_schwinger_tpu.utils import jaxcache

jaxcache.enable()

import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.io.stencil import csr_from_stencil
from deflatedmlmc_schwinger_tpu.oracles import MASS16, MASS128, SPEC16, SPEC128


def _load(spec, mass):
    """(StencilOperator, complex128 CSR) of a generated operator."""
    from deflatedmlmc_schwinger_tpu.io import load_operator

    op, _ = load_operator(spec, mass)
    return op, csr_from_stencil(np.asarray(op.coeffs))


@pytest.fixture(scope="session")
def op16():
    return _load(SPEC16, MASS16)


@pytest.fixture(scope="session")
def op128():
    return _load(SPEC128, MASS128)


@pytest.fixture(scope="session")
def dense16(op16):
    _, A = op16
    return np.asarray(A.todense())


@pytest.fixture(scope="session")
def exact16(dense16):
    """Dense-inverse oracle tr(D^-1) of the pinned 16^2 operator."""
    return complex(np.trace(np.linalg.inv(dense16)))


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided here, never at import)."""
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
    return jax.devices("gpu")[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Reset JAX's in-process executable caches after each test module.

    The unbounded jit cache keeps every compiled executable (and its
    captured hierarchy constants) alive for the whole suite, and letting
    XLA:CPU state accumulate across ~115 tests made a late fgmres
    COMPILATION segfault deterministically (the same test passes alone and
    the host had memory to spare, so it is toolchain state, not memory).
    Clearing between modules re-pays some per-module compiles but keeps
    each module's compilation environment fresh.
    """
    yield
    import gc

    jax.clear_caches()
    gc.collect()
