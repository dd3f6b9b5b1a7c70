"""Louvain community detection (synchronous modularity-gain label moving).

Reference workload: notebooks/Louvain.ipynb (argmax indexunary + modularity
reduce recipes).  The lowering here keeps communities as a one-hot
assignment matrix so the per-iteration "gain of moving node i to community c"
is one dense matmul:

    gain[i, c] = (A @ C)[i, c] - k_i * (k @ C)[c] / 2m

Dense in n x n — suitable for the notebook-scale graphs this workload
targets (n up to ~16k on one chip); the sparse large-graph variant arrives
with the blocked-sparse mxm.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .graph import Graph


@functools.partial(jax.jit, static_argnames=("n", "max_iters"))
def _louvain_loop(adj, k, two_m, n, max_iters):
    labels0 = jnp.arange(n, dtype=jnp.int32)

    def body(state):
        labels, _, it = state
        onehot = jax.nn.one_hot(labels, n, dtype=jnp.float32)  # (n, n) C
        w_to_comm = adj @ onehot  # (n, n): weight from i to community c
        comm_deg = k @ onehot  # (n,): total degree per community
        # remove self-contribution of i from its own community column
        own = jax.nn.one_hot(labels, n, dtype=jnp.float32)
        w_to_comm = w_to_comm  # staying-gain handled symmetrically
        gain = w_to_comm - k[:, None] * comm_deg[None, :] / two_m
        # moving to own community must compare against (comm minus self)
        gain_own = (
            jnp.take_along_axis(w_to_comm, labels[:, None], axis=1)[:, 0]
            - k * (jnp.take_along_axis(comm_deg[None, :], labels[None, :], axis=1)[0] - k)
            / two_m
        )
        gain = gain.at[jnp.arange(n), labels].set(gain_own)
        new_labels = jnp.argmax(gain, axis=1).astype(jnp.int32)
        changed = (new_labels != labels).any()
        return new_labels, changed, it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    labels, _, _ = jax.lax.while_loop(cond, body, (labels0, jnp.asarray(True), jnp.int32(0)))
    return labels


def modularity(adj, labels, two_m):
    """Q = (1/2m) * sum_ij (A_ij - k_i k_j / 2m) [c_i == c_j]."""
    k = adj.sum(axis=1)
    same = labels[:, None] == labels[None, :]
    q = jnp.where(same, adj - k[:, None] * k[None, :] / two_m, 0.0).sum() / two_m
    return q


def louvain(graph, *, max_iters=50, as_vector=False):
    """One-level Louvain labels (undirected view of the graph)."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n = graph.n
    valid = np.asarray(graph.valid)
    src = np.asarray(graph.src)[valid]
    dst = np.asarray(graph.dst)[valid]
    w = np.asarray(graph.weights)[valid] if graph.weights is not None else np.ones(len(src), np.float32)
    adj = np.zeros((n, n), np.float32)
    np.add.at(adj, (src, dst), w)
    np.add.at(adj, (dst, src), w)  # symmetrize
    np.fill_diagonal(adj, 0.0)
    adj_j = jnp.asarray(adj)
    k = adj_j.sum(axis=1)
    two_m = jnp.maximum(k.sum(), 1.0)
    labels = _louvain_loop(adj_j, k, two_m, n, int(max_iters))
    if as_vector:
        from ..core import dtypes as _dt
        from ..core.vector import Vector

        it = _dt.default_int()
        return Vector._from_arrays(labels.astype(it.np_type), jnp.ones((n,), bool), it)
    return labels
