"""Single-source shortest paths (Bellman-Ford over the min_plus semiring).

Reference recipe: notebooks/Intro to GraphBLAS + SSSP example.ipynb —
``dist(accum=binary.min) << A.T.mxv(dist, semiring.min_plus)`` iterated to a
fixed point.  Here the whole fixed-point loop is one compiled
``lax.while_loop`` over the O(E) edge-wise min_plus kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import edgewise as _ew
from .graph import Graph

_BIG = jnp.float32(3.4e38) / 4


@functools.partial(jax.jit, static_argnames=("n",))
def _sssp_loop(src, dst, w, valid, source, n):
    dist0 = jnp.full((n,), _BIG, jnp.float32).at[source].set(0.0)

    def cond(state):
        _, changed, it = state
        return changed & (it < n)

    def body(state):
        dist, _, it = state
        relaxed = _ew.spmv_min_plus(src, dst, w, valid, dist, n, big=_BIG)
        # dist(accum=min) << relaxed
        new_dist = jnp.minimum(dist, relaxed)
        return new_dist, (new_dist < dist).any(), it + 1

    dist, _, _ = jax.lax.while_loop(cond, body, (dist0, jnp.asarray(True), jnp.int32(0)))
    return dist


def sssp(graph, source, *, as_vector=False):
    """Shortest-path distances from ``source``; unreachable nodes absent."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    if graph.weights is None:
        raise ValueError("sssp requires an edge-weighted graph")
    dist = _sssp_loop(graph.src, graph.dst, graph.weights, graph.valid, int(source), graph.n)
    if as_vector:
        from ..core import dtypes as _dt
        from ..core.vector import Vector

        ft = _dt.default_float()  # FP64 under the 64-bit policy, else FP32 (docs/types.md)
        present = dist < _BIG
        return Vector._from_arrays(
            jnp.where(present, dist, 0).astype(ft.np_type), present, ft
        )
    return dist
