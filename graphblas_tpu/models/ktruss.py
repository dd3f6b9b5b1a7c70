"""k-truss — iterated masked support counting as dense matmuls.

Reference recipe: the LAGraph-style k-truss the reference's algorithm suite
models (SURVEY.md §6): support(e) = triangles through e = ``(A @ A) .* A``;
drop edges with support < k-2; repeat to fixpoint.  The lowering here
keeps the symmetric adjacency dense int32 and runs the whole fixpoint as one
``lax.while_loop`` of matmuls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .graph import Graph


@functools.partial(jax.jit, static_argnames=("k",))
def _ktruss_fixpoint(a0, k):
    """a0: (n, n) int32 symmetric adjacency, zero diagonal."""

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        a, _ = state
        support = (a @ a) * a
        a2 = jnp.where(support >= k - 2, a, 0)
        return a2, (a2 != a).any()

    a, _ = jax.lax.while_loop(cond, body, (a0, jnp.bool_(True)))
    return a


def k_truss(graph, k):
    """Maximal subgraph where every edge is in >= k-2 triangles.

    The input is symmetrized (treated as undirected) and self-loops are
    dropped.  Returns a new undirected ``Graph`` (both edge directions
    present) of the surviving edges.
    """
    if k < 3:
        raise ValueError(f"k must be >= 3 for a k-truss; got {k}")
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n = graph.n
    src = np.asarray(graph.src)[np.asarray(graph.valid)]
    dst = np.asarray(graph.dst)[np.asarray(graph.valid)]
    a = np.zeros((n, n), np.int32)
    a[src, dst] = 1
    a |= a.T
    np.fill_diagonal(a, 0)
    out = np.asarray(_ktruss_fixpoint(jnp.asarray(a), int(k)))
    rr, cc = np.nonzero(out)
    return Graph.from_arrays(rr.astype(np.int32), cc.astype(np.int32), n=n)
