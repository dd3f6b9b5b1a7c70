"""Edge-wise (COO segment) kernels: O(E) semiring SpMV for large sparse graphs.

The dense-masked engine is O(n^2) per mxv; for GAP-scale graphs the hot loops
in ``graphblas_tpu.models`` use this O(E) path instead: gather x at edge
sources, apply the semiring multiply per edge, segment-reduce to edge
destinations with the semiring add.  This is the segment-reduce analogue of
SuiteSparse's sparse mxv kernels (reference: the ``axb_method`` saxpy/dot
variants selected in core/ss/descriptor.py:76-82).

All functions are jit-compatible and shard-map friendly (static shapes; the
edge list is padded to a fixed length with neutral edges).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _jit(fn=None, *, static=()):
    if fn is None:
        return functools.partial(_jit, static=static)
    jfn = jax.jit(fn, static_argnames=static)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from jax._src import core as _jcore

        if not _jcore.trace_state_clean():
            # inside a gb.compile/loop trace: inline (see densemasked._jit)
            return fn(*args, **kwargs)
        return jfn(*args, **kwargs)

    return wrapper


def pad_edges(src, dst, w=None, *, pad_to=None):
    """Pad a COO edge list to a static length with invalid edges (host-side)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    e = len(src)
    if pad_to is None:
        pad_to = max(1, 1 << (e - 1).bit_length()) if e else 1
    pad = pad_to - e
    valid = np.zeros(pad_to, bool)
    valid[:e] = True
    src = np.pad(src, (0, pad))
    dst = np.pad(dst, (0, pad))
    if w is not None:
        w = np.pad(np.asarray(w), (0, pad))
    return src, dst, w, valid


@_jit(static=("n",))
def spmv_plus_times(src, dst, w, valid, x, n):
    """y[j] = sum over edges (i->j) of w * x[i]."""
    contrib = jnp.where(valid, w * x[src], 0)
    return jax.ops.segment_sum(contrib, dst, num_segments=n)


@_jit(static=("n",))
def spmv_plus_first(src, dst, valid, x, n):
    """y[j] = sum over edges (i->j) of x[i] (structure-only weights)."""
    contrib = jnp.where(valid, x[src], 0)
    return jax.ops.segment_sum(contrib, dst, num_segments=n)


@_jit(static=("n",))
def spmv_min_plus(src, dst, w, valid, x, n, *, big):
    """y[j] = min over edges (i->j) of (x[i] + w); absent encoded as ``big``."""
    contrib = jnp.where(valid, x[src] + w, big)
    contrib = jnp.where(x[src] >= big, big, contrib)  # absent source annihilates
    return jax.ops.segment_min(contrib, dst, num_segments=n)


@_jit(static=("n",))
def spmv_any_reach(src, dst, valid, frontier, n):
    """Boolean any_pair: y[j] = OR over edges (i->j) of frontier[i]."""
    contrib = (valid & frontier[src]).astype(jnp.int32)
    return jax.ops.segment_max(contrib, dst, num_segments=n) > 0

@_jit(static=("n",))
def spmv_any_parent(src, dst, valid, frontier, n):
    """any_firsti-style: y[j] = some source i with frontier[i]; -1 if none.
    Backs parent BFS (reference workload: notebooks/Example B.3)."""
    contrib = jnp.where(valid & frontier[src], src, -1)
    return jax.ops.segment_max(contrib, dst, num_segments=n)


@_jit(static=("n",))
def spmv_min_second(src, dst, valid, x, n, *, big):
    """y[j] = min over edges (i->j) of x[i] (min_second semiring; FastSV)."""
    contrib = jnp.where(valid, x[src], big)
    return jax.ops.segment_min(contrib, dst, num_segments=n)


def degrees(dst, valid, n):
    return jax.ops.segment_sum(jnp.where(valid, 1, 0), dst, num_segments=n)
