"""Frozen dataclasses registered as JAX pytrees.

Fields declared with ``static_field`` are pytree metadata: they are part of
the jit cache key and must be hashable; every other field is a traced leaf.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    return dataclasses.field(default=default, metadata=dict(static=True))


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Make ``cls`` a frozen dataclass, register it as a pytree, and give it
    ``.replace(**changes)``."""
    cls.replace = _replace
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))
