"""Betweenness centrality — batch Brandes as dense matmul sweeps.

Reference recipe: the LAGraph-style batch formulation the reference exposes
through its algorithm notebooks (SURVEY.md §6; cf. reference
notebooks/Louvain.ipynb companion workloads): a forward sweep accumulates
shortest-path counts level by level, a backward sweep accumulates
dependencies, and every step is an ``(ns, n) @ (n, n)`` product — the
The lowering here runs both sweeps as ``lax.scan`` over dense f32 matmuls
instead of masked SpGEMMs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .graph import Graph


@functools.partial(jax.jit, static_argnames=("max_levels",))
def _bc_sweeps(a, sources_onehot, max_levels):
    """a: (n, n) f32 adjacency (a[i, j] = 1 for edge i->j).
    sources_onehot: (ns, n) f32 one-hot rows."""

    def fwd(carry, _):
        paths, frontier = carry
        nxt = (frontier @ a) * (paths == 0)
        return (paths + nxt, nxt), nxt

    (paths, _), stack = jax.lax.scan(
        fwd, (sources_onehot, sources_onehot), None, length=max_levels
    )
    # stack[d] = frontier at depth d+1; prepend the sources as depth 0
    prev = jnp.concatenate([sources_onehot[None], stack[:-1]], axis=0)
    safe_paths = jnp.where(paths > 0, paths, 1.0)

    def bwd(bcu, frs):
        fr, fprev = frs
        t2 = jnp.where(fr > 0, (1.0 + bcu) / safe_paths, 0.0)
        t4 = jnp.where(fprev > 0, (t2 @ a.T) * paths, 0.0)
        return bcu + t4, None

    bcu, _ = jax.lax.scan(bwd, jnp.zeros_like(paths), (stack, prev), reverse=True)
    # Brandes never adds a source's dependency to its own score
    bcu = jnp.where(sources_onehot > 0, 0.0, bcu)
    return bcu.sum(axis=0)


def betweenness_centrality(graph, sources=None, *, max_levels=None):
    """Unnormalized betweenness centrality (directed; pass a symmetrized
    graph and halve for the undirected convention).

    ``sources`` restricts the batch to a sample of source vertices
    (approximate BC); default is all vertices (exact).  ``max_levels``
    bounds the sweep depth (default ``n - 1``; lower it to the graph's
    diameter to skip dead matmul steps).
    """
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n = graph.n
    src = np.asarray(graph.src)[np.asarray(graph.valid)]
    dst = np.asarray(graph.dst)[np.asarray(graph.valid)]
    a = np.zeros((n, n), np.float32)
    a[src, dst] = 1.0
    np.fill_diagonal(a, 0.0)
    if sources is None:
        onehot = np.eye(n, dtype=np.float32)
    else:
        sources = np.asarray(sources, np.int64)
        onehot = np.zeros((len(sources), n), np.float32)
        onehot[np.arange(len(sources)), sources] = 1.0
    if max_levels is None:
        max_levels = max(n - 1, 1)
    return _bc_sweeps(jnp.asarray(a), jnp.asarray(onehot), int(max_levels))
