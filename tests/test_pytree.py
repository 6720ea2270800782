"""The pytree dataclasses (ops/pytree.py): flatten/unflatten, static fields
as jit cache keys, ``.replace``, and the hierarchy containers built on them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deflatedmlmc_schwinger_tpu.mg.hierarchy import (
    BlockStencilOperator,
    Hierarchy,
    MGLevel,
)
from deflatedmlmc_schwinger_tpu.ops.cplx import CP
from deflatedmlmc_schwinger_tpu.ops.dirac import PairStencilOperator, StencilOperator
from deflatedmlmc_schwinger_tpu.ops.pytree import pytree_dataclass, static_field


@pytree_dataclass
class _Box:
    a: jnp.ndarray
    b: jnp.ndarray
    k: int = static_field(3)


def test_flatten_unflatten_roundtrip():
    box = _Box(jnp.arange(3.0), jnp.ones((2, 2)), k=5)
    leaves, treedef = jax.tree_util.tree_flatten(box)
    assert len(leaves) == 2                     # k is metadata, not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.k == 5
    np.testing.assert_array_equal(back.a, box.a)
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, box)
    np.testing.assert_array_equal(doubled.b, 2 * np.ones((2, 2)))
    assert doubled.k == 5


def test_static_field_is_jit_cache_key():
    traces = []

    @jax.jit
    def f(box):
        traces.append(box.k)
        return box.a * box.k

    np.testing.assert_array_equal(f(_Box(jnp.ones(2), jnp.ones(1), k=2)), [2.0, 2.0])
    f(_Box(jnp.zeros(2), jnp.ones(1), k=2))     # same static -> no retrace
    f(_Box(jnp.ones(2), jnp.ones(1), k=7))      # new static -> retrace
    assert traces == [2, 7]


def test_replace_and_frozen():
    box = _Box(jnp.zeros(1), jnp.zeros(1))
    new = box.replace(k=9)
    assert (box.k, new.k) == (3, 9)
    with pytest.raises(dataclasses.FrozenInstanceError):
        box.k = 4


def test_operator_containers_are_pytrees():
    C = CP(jnp.ones((2, 2, 5, 4, 4)), jnp.zeros((2, 2, 5, 4, 4)))
    pop = PairStencilOperator(coeffs=C, nx=4, nt=4)
    assert len(jax.tree_util.tree_leaves(pop)) == 2
    assert pop.replace(nt=8).nt == 8 and pop.nt == 4
    op = StencilOperator(coeffs=np.ones((2, 2, 5, 4, 4)), nx=4, nt=4)
    assert op.n == 32
    bs = BlockStencilOperator(blocks=CP(jnp.ones((4, 2, 3, 3)), jnp.ones((4, 2, 3, 3))),
                              offsets=(0, 1))
    assert len(jax.tree_util.tree_leaves(bs)) == 2   # gmat/gwin None, G static
    lev = MGLevel(op=pop, P=None, perm_shift=6)
    hier = Hierarchy(levels=(lev,), coarsest_inv=CP(jnp.eye(2), jnp.zeros((2, 2))),
                     poly_roots=((1 + 1j, 2.0),))
    leaves, treedef = jax.tree_util.tree_flatten(hier)
    assert len(leaves) == 4
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.levels[0].perm_shift == 6 and back.poly_roots == ((1 + 1j, 2.0),)
