"""Segmented reductions of the permutation-network SpMV, in plain JAX.

Two uses in the SpMV pipeline (ops/fastspmv.py):

- segmented forward-fill: propagate the value at the latest flagged
  position (expand x across CSR segments).  The flags are static per plan,
  so the fill is one ``take`` by a host-built index of the latest flagged
  slot (``build_fill_tables`` + ``segmented_fill_static``).
- segmented reduce ("add"/"min"/"max") of dst-sorted contributions: callers
  read only each segment's total (at its last slot), so the reduce is a
  sorted ``jax.ops.segment_*`` over the plan's static segment ids, and every
  slot gets its segment's total back (``t[seg]``).

On an H100 SXM (700 W) at 2^26 slots the segment form took 2.4-3.1 ms warm
and 0.2 s to compile; ``lax.associative_scan`` over (value, flag) pairs took
1.6-1.8 ms warm but 5.5-6.5 s to compile per use.  Segment ids computed in
the same program by ``cumsum`` made the segment form 11-34 ms, so the ids
are built on the host with the plan (``segment_ids``).

All functions compute in a 32-bit domain (``_no_x64``): the plan channels
are f32/int32 whatever ``jax_enable_x64`` says.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

# The loop-layout algorithms' "unreached" distance.  Finite (not inf) so
# BIG + w stays ordered and comparable; shared with models/fast.py.  The
# sssp state update writes it at non-last slots so those slots are valid
# DONORS for the loop network (see fastspmv.build_spmv_plan donor routing).
STATE_BIG = np.float32(3.4e38) / 4

_SEGMENT_OPS = {"add": jax.ops.segment_sum, "min": jax.ops.segment_min, "max": jax.ops.segment_max}


def _ident(op, dtype):
    if op in ("fill", "add"):
        return np.zeros((), dtype)[()]
    if np.issubdtype(np.dtype(dtype), np.floating):
        return np.asarray(np.inf if op == "min" else -np.inf, dtype)[()]
    info = np.iinfo(np.dtype(dtype))
    return np.asarray(info.max if op == "min" else info.min, dtype)[()]


def _no_x64(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.enable_x64(False):
            return fn(*args, **kwargs)

    return wrapper


def segment_ids(flags):
    """Host-side: the sorted segment id of every slot from segment-start
    flags (slot 0 must start a segment)."""
    flags = np.asarray(flags, bool).reshape(-1)
    assert flags.size == 0 or flags[0], "slot 0 must start a segment"
    return (np.cumsum(flags, dtype=np.int64) - 1).astype(np.int32)


def _reduce(values, seg, op, num_segments):
    totals = _SEGMENT_OPS[op](values, seg, num_segments=num_segments, indices_are_sorted=True)
    return totals[seg]


@functools.partial(jax.jit, static_argnames=("op", "num_segments"))
@_no_x64
def segmented_reduce(values, seg, op, num_segments):
    """Each slot's segment total under op in {"add", "min", "max"}: equal
    to an inclusive segmented scan at the segment-last slots.  ``seg`` is
    the sorted segment id per slot (``segment_ids``), below
    ``num_segments``."""
    return _reduce(values, seg, op, num_segments)


def build_fill_tables(flags):
    """Host-side analysis for ``segmented_fill_static``: with STATIC
    segment flags (per-plan CSR boundaries) the fill is a gather from the
    latest flagged slot.  Returns (src, has_prior): src[i] = the latest
    flagged slot <= i (0 when none — masked by has_prior)."""
    flags = np.asarray(flags, bool).reshape(-1)
    marked = np.where(flags, np.arange(flags.size, dtype=np.int64), -1)
    last = np.maximum.accumulate(marked) if flags.size else marked
    has_prior = last >= 0
    return np.maximum(last, 0).astype(np.int32), has_prior


@jax.jit
@_no_x64
def segmented_fill_static(values, src, has_prior):
    """Segmented forward-fill with STATIC flags, via the gather index from
    ``build_fill_tables``: slot i reads the value at the latest flagged
    slot <= i (0 before the first flag)."""
    taken = jnp.take(values, src, mode="clip")
    return jnp.where(has_prior, taken, jnp.zeros((), values.dtype))


def _contrib(x, w, valid, op, mul, wrap, io_dtype):
    """Per-edge semiring multiply + validity mask ahead of the scan.

    ``wrap=(bits, signed)`` truncates each contribution to a narrower integer
    width after the multiply — GraphBLAS integer semirings wrap at the output
    width (C semantics), so min/max over int32-computed products must compare
    the WRAPPED values to be bit-exact for INT8/INT16/UINT8/UINT16."""
    if w is not None:
        if mul == "times":
            x = x * w
        elif mul == "plus":
            x = x + w
        elif mul == "second":
            x = jnp.broadcast_to(w, x.shape).astype(x.dtype)
    if wrap is not None and mul in ("times", "plus"):
        bits, signed = wrap
        k = jnp.int32(32 - bits)
        if signed:
            x = jax.lax.shift_right_arithmetic(jax.lax.shift_left(x, k), k)
        else:
            x = jax.lax.bitwise_and(x, jnp.int32((1 << bits) - 1))
    return jnp.where(valid, x, jnp.asarray(_ident(op, io_dtype), x.dtype))


@functools.partial(jax.jit, static_argnames=("op", "mul", "num_segments", "wrap"))
@_no_x64
def segmented_reduce_contrib(xe, w, valid, seg, op, mul, num_segments, wrap=None):
    """Per-edge multiply + mask + segmented reduce (the SpMV reduce stage).
    ``w`` may be None (structure-only multiplies); ``wrap=(bits, signed)``
    truncates contributions to a narrow integer width (see _contrib)."""
    return _reduce(_contrib(xe, w, valid, op, mul, wrap, xe.dtype), seg, op, num_segments)


@functools.partial(jax.jit, static_argnames=("mode", "num_segments"))
@_no_x64
def segmented_reduce_state(mode, xe, w, valid, seg, num_segments, is_last, state, depth):
    """Segmented reduce of dst-sorted contributions + the BFS/SSSP state
    update read at segment-last slots.

    mode="bfs": state is levels (int32); returns (new_levels, frontier f32).
    mode="sssp": state is dist (f32); returns (new_dist, changed f32)."""
    op = "max" if mode == "bfs" else "min"
    x = xe.astype(jnp.float32)
    if w is not None:
        x = x + w
    out_v = _reduce(jnp.where(valid, x, _ident(op, np.float32)), seg, op, num_segments)
    if mode == "bfs":
        nxt = is_last & (out_v > 0) & (state < 0)
        return jnp.where(nxt, depth + 1, state), nxt.astype(jnp.float32)
    # non-last slots carry the min identity (STATE_BIG), NOT 0: they are the
    # loop network's donor slots for start slots whose vertex has no state
    new = jnp.where(is_last, jnp.minimum(state, out_v), STATE_BIG)
    return new, (new < state).astype(jnp.float32)
