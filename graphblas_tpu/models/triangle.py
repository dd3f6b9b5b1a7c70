"""Triangle counting — masked plus_pair SpGEMM on L·U, as block matmuls.

Reference recipe: notebooks/Louvain.ipynb triangle-count step
(``C(L.S) << L.mxm(U, plus_pair); C.reduce_scalar()``).  The dense
lowering is a blocked boolean matmul: tc = sum over (i,j) in L of (L @ L^T),
computed block-by-block in int32 matmuls so only O(n * block) memory is
live at once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .graph import Graph

_BLOCK = 1024


@functools.partial(jax.jit, static_argnames=("nblocks",))
def _tc_blocked(ls, nblocks):
    """ls: (n, n) int8 lower-triangular struct (padded to nblocks*_BLOCK rows)."""

    def body(carry, i):
        block = jax.lax.dynamic_slice_in_dim(ls, i * _BLOCK, _BLOCK, 0).astype(jnp.int32)
        # wedges[b, j] = |N_L(row b) ∩ N_L(j)|
        wedges = block @ ls.astype(jnp.int32).T
        # count only where (row, j) is itself an edge in L
        tri = jnp.sum(wedges * block)
        return carry + tri, None

    total, _ = jax.lax.scan(body, jnp.int64(0), jnp.arange(nblocks))
    return total


def triangle_count(graph):
    """Count undirected triangles.  Self-loops ignored; edges deduplicated."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    src = np.asarray(graph.src)[np.asarray(graph.valid)]
    dst = np.asarray(graph.dst)[np.asarray(graph.valid)]
    n = graph.n
    # build L: strictly-lower-triangular undirected struct
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    npad = -(-n // _BLOCK) * _BLOCK
    ls = np.zeros((npad, npad), np.int8)
    ls[hi, lo] = 1  # row > col: strictly lower
    total = _tc_blocked(jnp.asarray(ls), npad // _BLOCK)
    return int(total)
