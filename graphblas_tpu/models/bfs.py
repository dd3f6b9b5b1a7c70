"""Level & parent BFS — single compiled lax.while_loop.

Reference recipes: notebooks/Example B.1 (level BFS: structural/complemented
masks + any_pair mxv) and B.3 (parent BFS: any_secondi semiring).  Here the
masked semiring mxv per level is one O(E) edge-wise kernel and the whole
traversal is one XLA program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import edgewise as _ew
from .graph import Graph


@functools.partial(jax.jit, static_argnames=("n",))
def _bfs_level_loop(src, dst, valid, source, n):
    levels0 = jnp.full((n,), -1, jnp.int32).at[source].set(0)
    frontier0 = jnp.zeros((n,), bool).at[source].set(True)

    def cond(state):
        _, frontier, depth = state
        return frontier.any() & (depth < n)

    def body(state):
        levels, frontier, depth = state
        # w(~visited.S, replace) << A.T.mxv(frontier, any_pair) — fused:
        reached = _ew.spmv_any_reach(src, dst, valid, frontier, n)
        nxt = reached & (levels < 0)
        levels = jnp.where(nxt, depth + 1, levels)
        return levels, nxt, depth + 1

    levels, _, _ = jax.lax.while_loop(cond, body, (levels0, frontier0, jnp.int32(0)))
    return levels


@functools.partial(jax.jit, static_argnames=("n",))
def _bfs_parent_loop(src, dst, valid, source, n):
    parents0 = jnp.full((n,), -1, jnp.int32).at[source].set(source)
    frontier0 = jnp.zeros((n,), bool).at[source].set(True)

    def cond(state):
        _, frontier, depth = state
        return frontier.any() & (depth < n)

    def body(state):
        parents, frontier, depth = state
        # v(~visited.S, replace) << A.T.mxv(frontier, any_secondi) — fused:
        cand = _ew.spmv_any_parent(src, dst, valid, frontier, n)
        nxt = (cand >= 0) & (parents < 0)
        parents = jnp.where(nxt, cand, parents)
        return parents, nxt, depth + 1

    parents, _, _ = jax.lax.while_loop(cond, body, (parents0, frontier0, jnp.int32(0)))
    return parents


def bfs_level(graph, source, *, as_vector=False):
    """BFS levels from ``source``; -1 (absent) = unreachable.  Level of the
    source is 0 (matching notebooks/Example B.1 up to its 1-based variant)."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    levels = _bfs_level_loop(graph.src, graph.dst, graph.valid, int(source), graph.n)
    if as_vector:
        return _levels_to_vector(levels)
    return levels


def bfs_parent(graph, source, *, as_vector=False):
    """BFS parent tree from ``source``; parent of source is itself; -1 =
    unreachable (reference recipe: notebooks/Example B.3)."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    parents = _bfs_parent_loop(graph.src, graph.dst, graph.valid, int(source), graph.n)
    if as_vector:
        return _levels_to_vector(parents)
    return parents


def _levels_to_vector(levels):
    from ..core import dtypes as _dt
    from ..core.vector import Vector

    it = _dt.default_int()  # INT64 under the 64-bit policy, else INT32 (docs/types.md)
    return Vector._from_arrays(levels.astype(it.np_type), levels >= 0, it)
