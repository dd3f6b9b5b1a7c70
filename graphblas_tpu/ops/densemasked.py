"""Dense-masked reference engine: every GraphBLAS operation family on
(values, struct) pairs of static-shape device arrays.

This module replaces the SuiteSparse:GraphBLAS compute engine (reference layer
L0; every ``cfunc_name`` string in /root/reference/graphblas/core/matrix.py,
e.g. ``GrB_mxm`` at core/matrix.py:2321, dispatches to C code that this module
reimplements in JAX).  Representation:

- a Matrix is ``(values[nrows, ncols], struct[nrows, ncols] bool)``
- a Vector is ``(values[size], struct[size] bool)``
- absent positions hold the dtype's zero (canonical form)

All entry points are ``jax.jit``-compiled with operators passed statically, so
each (op, shape, dtype) specializes once and then replays from the XLA cache —
the analogue of SuiteSparse's runtime JIT specializing C kernels per op/type.

Monoid reduction uses a variadic ``lax.reduce`` over (value, present) pairs::

    comp((va, pa), (vb, pb)) = (pa & pb ? fn(va, vb) : pa ? va : vb, pa | pb)

which is associative whenever ``fn`` is, needs no identity element (so the
ANY monoid and IEEE edge cases need no special identity plumbing), and
matches "reduce only over present entries" semantics exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

_MXM_CHUNK = 128  # k-chunk for the generic semiring matmul (bounds memory to m*n*chunk)


def _jit(fn=None, *, static=()):
    """jax.jit wrapper for engine entry points; inside a gb.compile/loop
    trace it inlines the raw function instead."""
    if fn is None:
        return functools.partial(_jit, static=static)
    jfn = jax.jit(fn, static_argnames=static)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from jax._src import core as _jcore

        if not _jcore.trace_state_clean():
            # inside a gb.compile/loop trace: inline the raw function so
            # concrete (structure) inputs stay concrete — an inner jit would
            # turn every output into a tracer and defeat structure hoisting
            return fn(*args, **kwargs)
        return jfn(*args, **kwargs)

    return wrapper


def _iota_np():
    """Index dtype for positional iotas under the 64-bit contract: int64 at
    full width only when the platform executes it (astype/iota at int64
    under a 32-bit policy warns and truncates to int32 anyway)."""
    from ..core import dtypes as _dtm

    return jnp.int64 if _dtm.executes_64bit() else jnp.int32


def zero_of(dtype):
    return np.zeros((), dtype)[()]


def _is_soa(values):
    """UDT collections store values as a dict of field arrays (SoA)."""
    return isinstance(values, dict)


def tmap(fn, values, *rest):
    """Apply fn per leaf for SoA values, directly otherwise."""
    if _is_soa(values):
        out = {}
        for key in values:
            out[key] = fn(values[key], *(r[key] for r in rest))
        return out
    return fn(values, *rest)


# ---------------------------------------------------------------------------
# Structure math that stays HOST-side during outer traces
# ---------------------------------------------------------------------------
#
# Inside a gb.compile/gb.loop trace every jnp op binds to the trace — even on
# concrete (non-abstract) operands — so device structure bitmaps would become
# tracers after one combine, defeating structure hoisting (core/compiler.py).
# These combinators detect "in an outer trace AND all operands concrete" and
# run the structure op in numpy on the host (a trace-time constant);
# otherwise they are plain jnp ops.


def _host_concrete(*arrays):
    import jax
    from jax._src import core as _jcore

    if _jcore.trace_state_clean():
        return False
    return all(not isinstance(a, jax.core.Tracer) for a in arrays)


def _is_tracer_arr(x):
    import jax

    return isinstance(x, jax.core.Tracer)


def _concrete_const(x):
    """(is_concrete, all_true, all_false) for structure algebra short-cuts."""
    import jax

    if isinstance(x, jax.core.Tracer):
        return False, False, False
    xa = np.asarray(x)
    return True, bool(xa.all()), bool(not xa.any())


def s_and(a, b):
    if _host_concrete(a, b):
        return np.logical_and(np.asarray(a), np.asarray(b))
    # algebraic short-circuits keep structure CONCRETE under traces when one
    # side is a known constant (dense-full loop states: x & True == x,
    # x & False == False) — required for compiled-loop structure hoisting
    from jax._src import core as _jcore

    # short-circuits must preserve broadcast shape (ADVICE r4): all current
    # call sites pass equal shapes, so only engage them in that case
    if not _jcore.trace_state_clean() and np.shape(a) == np.shape(b):
        ca, ta, fa = _concrete_const(a)
        if ca and ta:
            return b
        if ca and fa:
            return np.zeros_like(np.asarray(a), bool)
        cb, tb, fb = _concrete_const(b)
        if cb and tb:
            return a
        if cb and fb:
            return np.zeros_like(np.asarray(b), bool)
    return a & b


def s_or(a, b):
    if _host_concrete(a, b):
        return np.logical_or(np.asarray(a), np.asarray(b))
    from jax._src import core as _jcore

    if not _jcore.trace_state_clean() and np.shape(a) == np.shape(b):
        ca, ta, fa = _concrete_const(a)
        if ca and ta:
            return np.ones_like(np.asarray(a), bool)
        if ca and fa:
            return b
        cb, tb, fb = _concrete_const(b)
        if cb and tb:
            return np.ones_like(np.asarray(b), bool)
        if cb and fb:
            return a
    return a | b


def s_not(a):
    if _host_concrete(a):
        return np.logical_not(np.asarray(a))
    return ~a


def s_where(c, a, b):
    if _host_concrete(c, a, b):
        return np.where(np.asarray(c), np.asarray(a), np.asarray(b))
    from jax._src import core as _jcore

    if not _jcore.trace_state_clean():
        cc, ct, cf = _concrete_const(c)
        if cc and ct:
            return a
        if cc and cf:
            return b
        import jax

        # traced condition but both branches concrete AND equal: the result
        # is that constant (e.g. merging an all-True structure with an
        # all-True structure under a value mask) — keeps compiled-loop
        # structure hoisting alive for dense-full states
        if not isinstance(a, jax.core.Tracer) and not isinstance(b, jax.core.Tracer):
            an, bn = np.asarray(a), np.asarray(b)
            try:
                ab, bb = np.broadcast_arrays(an, bn)
            except ValueError:
                ab = bb = None
            if ab is not None and np.array_equal(ab, bb):
                shape = np.broadcast_shapes(np.shape(c), ab.shape)
                return np.broadcast_to(ab, shape).copy()
            # edge-layout invariant rule (core/looplayout.py): in-context,
            # every traced mask is a subset of the state universe U
            # (is_last); when both branches are true throughout U and the
            # false branch has nothing outside U, where(c, a, b) == U for
            # ANY c ⊆ U.  This is the edge-space analogue of the n-space
            # "cs is all-True" short-circuit that keeps structure hoisting
            # alive for masked assigns on full states.
            if ab is not None:
                from ..core import looplayout as _ll

                ctx = _ll.active()
                if ctx is not None and np.shape(c) == (ctx.e_pad,):
                    U = ctx.is_last
                    try:
                        aU = np.broadcast_to(an, (ctx.e_pad,))
                        bU = np.broadcast_to(bn, (ctx.e_pad,))
                    except ValueError:
                        aU = None
                    if (
                        aU is not None
                        and aU[U].all()
                        and bU[U].all()
                        and not bU[~U].any()
                    ):
                        return U.copy()
    return jnp.where(c, a, b)


def s_any(a, axis=None):
    if _host_concrete(a):
        return np.any(np.asarray(a), axis=axis)
    return jnp.any(a, axis=axis)


def s_zeros(shape):
    """Fresh all-absent structure bitmap (np inside traces, device outside)."""
    from jax._src import core as _jcore

    if not _jcore.trace_state_clean():
        return np.zeros(shape, bool)
    return jnp.zeros(shape, bool)


def s_ones(shape):
    from jax._src import core as _jcore

    if not _jcore.trace_state_clean():
        return np.ones(shape, bool)
    return jnp.ones(shape, bool)


def canonical(values, struct):
    """Force absent positions to zero (storage invariant)."""
    return tmap(lambda v: jnp.where(struct, v, zero_of(v.dtype)), values), struct


# ---------------------------------------------------------------------------
# Monoid reduction core
# ---------------------------------------------------------------------------


def _pair_reduce(values, struct, fn, axes):
    """Reduce (values, struct) over ``axes`` with the present-aware monoid.

    Lowered as a log-depth halving tree rather than ``lax.reduce``: the XLA
    reduce computation cannot host control flow (e.g. ``jnp.gcd``'s
    ``while_loop`` hard-aborts the CPU backend at compile time), while plain
    elementwise folds can. Only exotic monoids reach this path — the common
    ones take the vectorized branches in ``_monoid_reduce``.
    """
    soa = _is_soa(values)
    ndim = struct.ndim
    axes = tuple(sorted(ax % ndim for ax in axes))
    keep = tuple(i for i in range(ndim) if i not in axes)
    perm = keep + axes

    def rearrange(x):
        x = jnp.transpose(x, perm)
        return x.reshape(x.shape[: len(keep)] + (-1,))

    s = rearrange(struct)
    v = {k: rearrange(x) for k, x in values.items()} if soa else rearrange(values)
    keep_shape = s.shape[:-1]
    if s.shape[-1] == 0:
        empty_s = jnp.zeros(keep_shape, bool)
        if soa:
            return {k: jnp.zeros(keep_shape, x.dtype) for k, x in v.items()}, empty_s
        return jnp.zeros(keep_shape, v.dtype), empty_s

    def tail_pad(x, lo, hi, padn):
        part = x[..., lo:hi]
        if padn:
            part = jnp.pad(part, [(0, 0)] * (part.ndim - 1) + [(0, padn)])
        return part

    while s.shape[-1] > 1:
        r = s.shape[-1]
        h = (r + 1) // 2
        padn = 2 * h - r  # pad the b half with absent entries
        pa = s[..., :h]
        pb = tail_pad(s, h, r, padn)
        both = pa & pb
        if soa:
            va = {k: x[..., :h] for k, x in v.items()}
            vb = {k: tail_pad(x, h, r, padn) for k, x in v.items()}
            out = fn(va, vb)
            v = {
                k: jnp.where(both, out[k], jnp.where(pa, va[k], vb[k])) for k in va
            }
        else:
            va = v[..., :h]
            vb = tail_pad(v, h, r, padn)
            v = jnp.where(both, fn(va, vb), jnp.where(pa, va, vb))
        s = pa | pb
    if soa:
        return {k: x[..., 0] for k, x in v.items()}, s[..., 0]
    return v[..., 0], s[..., 0]


def _monoid_reduce(values, struct, monoid, axes):
    """Reduce with a typed monoid; fast vectorized paths for the common
    monoids, present-aware pair reduce for the rest."""
    name = monoid.parent.name if hasattr(monoid, "parent") else None
    if _is_soa(values):
        return _pair_reduce(values, struct, monoid.fn if monoid.fn is not None else (lambda a, b: a), tuple(axes))
    dtype = values.dtype
    if name in {"plus", "times", "lor", "land", "min", "max"} and not jnp.issubdtype(dtype, jnp.complexfloating):
        if name == "plus":
            if dtype == jnp.bool_:
                out = jnp.any(values & struct, axis=axes)
            else:
                out = jnp.sum(jnp.where(struct, values, zero_of(dtype)), axis=axes)
        elif name == "times":
            if dtype == jnp.bool_:
                out = jnp.all(jnp.where(struct, values, True), axis=axes)
            else:
                out = jnp.prod(jnp.where(struct, values, np.asarray(1, dtype)), axis=axes)
        elif name == "lor":
            out = jnp.any(jnp.where(struct, values.astype(bool), False), axis=axes).astype(dtype)
        elif name == "land":
            out = jnp.all(jnp.where(struct, values.astype(bool), True), axis=axes).astype(dtype)
        elif name == "min":
            ident = monoid.identity
            out = jnp.min(jnp.where(struct, values, ident), axis=axes)
        else:  # max
            ident = monoid.identity
            out = jnp.max(jnp.where(struct, values, ident), axis=axes)
        return out, s_any(struct, axis=axes)
    return _pair_reduce(values, struct, monoid.fn if monoid.fn is not None else (lambda a, b: a), tuple(axes))


@_jit(static=("monoid", "axis"))
def reduce_axis(values, struct, monoid, axis):
    """Rowwise (axis=1) / columnwise (axis=0) monoid reduce -> vector.
    Reference: GrB_Matrix_reduce_Monoid (core/matrix.py:2636-2735)."""
    v, s = _monoid_reduce(values, struct, monoid, (axis,))
    return canonical(v, s)


@_jit(static=("monoid",))
def reduce_all(values, struct, monoid):
    """Full monoid reduce -> scalar.  Reference: GrB_Matrix_reduce_<T>."""
    v, s = _monoid_reduce(
        tmap(lambda a: a.reshape(-1), values), struct.reshape(-1), monoid, (0,)
    )
    return v, s


# ---------------------------------------------------------------------------
# Elementwise family
# ---------------------------------------------------------------------------


def _safe(values, struct, op):
    """Substitute absent values with 1 before applying fns that can trap/junk
    on the 0 canonical fill (integer division etc.)."""
    parent = getattr(op, "parent", None)
    if parent is not None and getattr(parent, "_needs_safe_fill", False):
        return jnp.where(struct, values, np.asarray(1, values.dtype))
    return values


@_jit(static=("op",))
def apply_unary(values, struct, op):
    """GrB_Matrix_apply (reference: core/matrix.py:2375-2533)."""
    if _is_soa(values):
        out = op.fn(values)
    else:
        out = op.fn(_safe(values, struct, op))
    return canonical(out, struct)


@_jit(static=("op", "side"))
def apply_bound(values, struct, op, bound, side):
    """Apply a binary op with one argument bound to a scalar.  ``bound`` is a
    TRACED argument: closing over it under a static op would bake the first
    value seen into the jit cache (GrB_apply_BinaryOp1st/2nd)."""
    parent = getattr(op, "parent", None)
    if parent is not None and getattr(parent, "_needs_safe_fill", False):
        values = jnp.where(struct, values, np.asarray(1, values.dtype))
    if side == "right":
        out = op.fn(values, bound)
    else:
        out = op.fn(bound, values)
    return canonical(out, struct)


@_jit(static=("op", "offset"))
def apply_positional_unary(values, struct, op, offset):
    which, delta = op.positional if not isinstance(op.positional, str) else (op.positional, 0)
    shape = values.shape
    if len(shape) == 1:
        idx = jax.lax.broadcasted_iota(_iota_np(), (shape[0], 1), 0)[:, 0]
    else:
        dim = 0 if which == "i" else 1
        idx = jax.lax.broadcasted_iota(_iota_np(), shape, dim)
    out = (idx + delta + offset).astype(op.return_type.np_type)
    return canonical(jnp.broadcast_to(out, shape), struct)


def _index_grids(shape):
    if len(shape) == 1:
        i = jax.lax.broadcasted_iota(_iota_np(), (shape[0], 1), 0)[:, 0]
        j = jnp.zeros_like(i)
    else:
        i = jax.lax.broadcasted_iota(_iota_np(), shape, 0)
        j = jax.lax.broadcasted_iota(_iota_np(), shape, 1)
    return i, j


@_jit(static=("op",))
def apply_indexunary(values, struct, op, thunk):
    """GrB_Matrix_apply_IndexOp (reference: core/matrix.py:2451-2533)."""
    i, j = _index_grids(values.shape)
    out = op.fn(_safe(values, struct, op), i, j, thunk)
    return canonical(out, struct)


@_jit(static=("op",))
def select_op(values, struct, op, thunk):
    """GrB_Matrix_select_* (reference: core/matrix.py:2534-2635)."""
    i, j = _index_grids(values.shape)
    keep = op.fn(values, i, j, thunk)
    return canonical(values, struct & keep)


@_jit(static=("op",))
def ewise_mult(av, as_, bv, bs, op):
    """GrB_Matrix_eWiseMult (intersection).  Reference: core/matrix.py:1952."""
    struct = s_and(as_, bs)
    if op.is_positional:
        return _positional_ewise(_shape_of(av), struct, op)
    if _is_soa(av):
        out = op.fn(av, bv)
    else:
        out = op.fn(_safe(av, as_, op), _safe(bv, bs, op))
    return canonical(out, struct)


@_jit(static=("op",))
def ewise_add(av, as_, bv, bs, op):
    """GrB_Matrix_eWiseAdd (union; both-present uses op).
    Reference: core/matrix.py:1861."""
    struct = s_or(as_, bs)
    if op.is_positional:
        return _positional_ewise(_shape_of(av), struct, op)
    both = s_and(as_, bs)
    if _is_soa(av):
        out = op.fn(av, bv)
        out = {
            key: jnp.where(both, out[key], jnp.where(as_, av[key], bv[key])) for key in out
        }
        return canonical(out, struct)
    out = op.fn(_safe(av, as_, op), _safe(bv, bs, op))
    # non-intersecting entries pass through, cast to the op's output dtype
    out = jnp.where(both, out, jnp.where(as_, av.astype(out.dtype), bv.astype(out.dtype)))
    return canonical(out, struct)


@_jit(static=("op",))
def ewise_union(av, as_, bv, bs, op, left_default, right_default):
    """GxB_Matrix_eWiseUnion (union; absent side uses default).
    Reference: core/matrix.py:2043."""
    struct = s_or(as_, bs)
    if op.is_positional:
        return _positional_ewise(av.shape, struct, op)
    a_filled = jnp.where(as_, av, left_default.astype(av.dtype))
    b_filled = jnp.where(bs, bv, right_default.astype(bv.dtype))
    out = op.fn(a_filled, b_filled)
    return canonical(out, struct)


def _shape_of(values):
    if _is_soa(values):
        return next(iter(values.values())).shape
    return values.shape


def _positional_ewise(shape, struct, op):
    which, delta = op.positional
    i, j = _index_grids(shape)
    idx = {"firsti": i, "firstj": j, "secondi": i, "secondj": j}[which]
    out = (idx + delta).astype(op.return_type.np_type)
    return canonical(out, struct)


# ---------------------------------------------------------------------------
# Semiring matmul family (mxm / mxv / vxm)
# ---------------------------------------------------------------------------


def _mxm_fast_path(av, as_, bv, bs, semiring, out_np_dtype):
    """Matmul lowerings for semirings that map onto plus-times algebra.

    plus_times       -> A @ B on values (absent = 0 annihilates)
    plus_pair/oneb   -> struct @ struct (overlap counts)
    plus_first       -> A @ struct ; plus_second -> struct @ B
    any/lor_pair,land,times over bool -> overlap > 0
    Returns None when no fast form applies.
    """
    add = semiring.monoid.parent.name
    mul = semiring.binaryop.parent.name
    a_bool = as_
    b_bool = bs
    if jnp.issubdtype(jnp.dtype(out_np_dtype), jnp.complexfloating):
        return None
    acc_dtype = np.promote_types(out_np_dtype, np.int32) if np.issubdtype(out_np_dtype, np.integer) else out_np_dtype
    if np.issubdtype(np.dtype(out_np_dtype), np.bool_):
        acc_dtype = np.int32

    def mm(x, y):
        # HIGHEST: the GPU's default f32 matmul precision may run in TF32 —
        # silent mantissa loss vs the reference's exact CPU semirings.
        # Reduced-precision multiplies are never an implicit downgrade.
        prec = (
            jax.lax.Precision.HIGHEST
            if jnp.issubdtype(jnp.dtype(acc_dtype), jnp.floating)
            else None
        )
        return jnp.matmul(
            x, y, preferred_element_type=jnp.dtype(acc_dtype), precision=prec
        )

    overlap = None

    def get_overlap():
        nonlocal overlap
        if overlap is None:
            overlap = mm(a_bool.astype(np.int32), b_bool.astype(np.int32))
        return overlap

    if add == "plus" and not np.issubdtype(np.dtype(out_np_dtype), np.bool_):
        if mul == "times":
            cv = mm(av.astype(acc_dtype), bv.astype(acc_dtype))
        elif mul in {"pair", "oneb"}:
            cv = get_overlap().astype(acc_dtype)
        elif mul == "first":
            cv = mm(av.astype(acc_dtype), b_bool.astype(acc_dtype))
        elif mul == "second":
            cv = mm(a_bool.astype(acc_dtype), bv.astype(acc_dtype))
        else:
            return None
        cs = get_overlap() > 0
        return cv.astype(out_np_dtype), cs
    if add in {"lor", "any", "lxor", "plus"} and mul in {"pair", "oneb", "land", "times", "lor", "first", "second"}:
        if np.dtype(out_np_dtype) == np.bool_ and mul in {"pair", "oneb"}:
            # purely structural: reachability
            cs = get_overlap() > 0
            if add == "lxor":
                cv = get_overlap() % 2 == 1
            else:
                cv = cs
            return cv, cs
    return None


def _mul_values(avk, bvk, ik, kk, jk, mul):
    """Compute the (m, ck, n) product block for a typed multiply op, handling
    positional multiplies (firsti/secondj/... produce indices, reference:
    core/operator/base.py:33-87)."""
    pos = mul.positional
    if pos is None:
        return mul.fn(avk[:, :, None], bvk[None, :, :])
    if pos == "indexbinary":
        return mul.fn(avk[:, :, None], ik, kk, bvk[None, :, :], kk, jk)
    which, delta = pos
    # a is indexed (i, k); b is indexed (k, j)
    idx = {"firsti": ik, "firstj": kk, "secondi": kk, "secondj": jk}[which]
    return (idx + delta).astype(mul.return_type.np_type)


def _pallas_mxm_allowed(semiring, out_np, m, n, strategy):
    """Static decision: lower tropical-family semirings to the Triton
    kernel (ops/tropical) on the GPU; Triton compiles for no other device."""
    if strategy not in {"auto", "pallas"}:
        return False
    if m * n < 128 * 128 and strategy != "pallas":
        return False
    if jax.default_backend() != "gpu":
        return False
    from .tropical import is_tropical

    add = semiring.monoid.parent.name
    mul = semiring.binaryop.parent.name
    if not is_tropical(add, mul, out_np):
        return False
    # the kernel computes in f32; auto never downgrades f64 silently —
    # strategy="pallas" is the explicit opt-in to f32 compute
    if out_np != np.float32 and strategy != "pallas":
        return False
    return True


def _mxm_soa(av, as_, bv, bs, semiring, out_dtype):
    """Generic semiring contraction over SoA (UDT) operands.

    Chunks k with a static Python loop (unrolled; UDT collections live in
    the dense-masked DSL at modest sizes): each chunk broadcasts the typed
    multiply per field to (m, ck, n), present-aware monoid-reduces over k,
    and chunks merge with the monoid.  Mirrors GrB_mxm over user-defined
    types (reference: core/matrix.py:2264-2331 + core/operator/binary.py
    UDT registration)."""
    m, k = as_.shape
    _, n = bs.shape
    add = semiring.monoid
    mul = semiring.binaryop
    fn = add.fn if add.fn is not None else (lambda a, b: a)
    chunk = min(_MXM_CHUNK, max(k, 1))
    pad = (-k) % chunk if k else chunk
    if pad or k == 0:
        p = pad if k else chunk
        av = tmap(lambda x: jnp.pad(x, ((0, 0), (0, p))), av)
        as_ = jnp.pad(as_, ((0, 0), (0, p)))
        bv = tmap(lambda x: jnp.pad(x, ((0, p), (0, 0))), bv)
        bs = jnp.pad(bs, ((0, p), (0, 0)))
    nchunks = as_.shape[1] // chunk

    i_grid = jax.lax.broadcasted_iota(_iota_np(), (m, chunk, n), 0)
    j_grid = jax.lax.broadcasted_iota(_iota_np(), (m, chunk, n), 2)
    k_local = jax.lax.broadcasted_iota(_iota_np(), (m, chunk, n), 1)

    cv = cs = None
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        a_b = tmap(lambda x: x[:, sl][:, :, None], av)
        b_b = tmap(lambda x: x[sl][None, :, :], bv)
        if mul.positional is None:
            prod = mul.fn(a_b, b_b)
        elif mul.positional == "indexbinary":
            prod = mul.fn(a_b, i_grid, k_local + c * chunk, b_b, k_local + c * chunk, j_grid)
        else:
            which, delta = mul.positional
            kk = k_local + c * chunk
            idx = {"firsti": i_grid, "firstj": kk, "secondi": kk, "secondj": j_grid}[which]
            prod = (idx + delta).astype(mul.return_type.np_type)
        prod = tmap(lambda x: jnp.broadcast_to(x, (m, chunk, n)), prod)
        pres = jnp.broadcast_to(as_[:, sl][:, :, None] & bs[sl][None, :, :], (m, chunk, n))
        bv_red, bs_red = _pair_reduce(prod, pres, fn, (1,))
        if cv is None:
            cv, cs = bv_red, bs_red
        else:
            both = cs & bs_red
            merged = fn(cv, bv_red)
            keep_c = cs
            cv = tmap(
                lambda mg, a, b: jnp.where(both, mg, jnp.where(keep_c, a, b)),
                merged,
                cv,
                bv_red,
            )
            cs = cs | bs_red
    return canonical(cv, cs)


@_jit(static=("semiring", "out_dtype", "strategy"))
def mxm(av, as_, bv, bs, semiring, out_dtype, strategy="auto"):
    """GrB_mxm dispatcher; see _mxm_paths.  When the operand structures are
    trace-time constants (structure hoisting, core/compiler.py), the output
    structure — any_k(as_[i,k] & bs[k,j]), semiring-independent — is computed
    host-side so it stays constant through compiled loops."""
    cv, cs = _mxm_paths(av, as_, bv, bs, semiring, out_dtype, strategy)
    if _host_concrete(as_, bs) and not _is_soa(av) and not _is_soa(bv):
        a_np = np.asarray(as_).astype(np.float32)
        b_np = np.asarray(bs).astype(np.float32)
        cs_np = (a_np @ b_np) > 0
        return tmap(lambda v: jnp.where(cs_np, v, zero_of(v.dtype)), cv), cs_np
    return cv, cs


def _mxm_paths(av, as_, bv, bs, semiring, out_dtype, strategy="auto"):
    """GrB_mxm over any semiring (reference: core/matrix.py:2264-2331).

    Strategy 1: matmul forms for plus_times-family semirings.
    Strategy 2: the Pallas/Triton kernel for tropical-family semirings
    (min_plus/max_plus/min_max/max_min) on the GPU (ops/tropical).
    Strategy 3: generic chunked semiring contraction — scan over k-chunks,
    each chunk does an (m, ck, n) broadcast multiply + present-aware monoid
    reduce, chunks combine with the monoid.
    Strategy 4: SoA per-field contraction for UDT operands (_mxm_soa).

    ``strategy`` is the per-call descriptor override (tx.config
    "mxm_strategy": auto | mxu | pallas | generic); it is a STATIC jit arg
    so each strategy compiles its own kernel — reading mutable global config
    inside the traced body would bake the first-seen value into the cache.
    """
    if _is_soa(av) or _is_soa(bv):
        return _mxm_soa(av, as_, bv, bs, semiring, out_dtype)
    out_np = np.dtype(out_dtype.np_type)
    m, k = av.shape
    k2, n = bv.shape
    fast = None
    if semiring.binaryop.positional is None and strategy in {"auto", "mxu"}:
        fast = _mxm_fast_path(av, as_, bv, bs, semiring, out_np)
    if fast is not None:
        cv, cs = fast
        return canonical(cv.astype(out_np), cs)
    if semiring.binaryop.positional is None and _pallas_mxm_allowed(semiring, out_np, m, n, strategy):
        from .tropical import tropical_mxm

        cv, cs = tropical_mxm(
            av, as_, bv, bs, semiring.monoid.parent.name, semiring.binaryop.parent.name, out_np
        )
        return canonical(cv, cs)

    add = semiring.monoid
    mul = semiring.binaryop
    chunk = min(_MXM_CHUNK, max(k, 1))
    pad = (-k) % chunk if k else chunk
    if pad or k == 0:
        av = jnp.pad(av, ((0, 0), (0, pad if k else chunk)))
        as_ = jnp.pad(as_, ((0, 0), (0, pad if k else chunk)))
        bv = jnp.pad(bv, ((0, pad if k else chunk), (0, 0)))
        bs = jnp.pad(bs, ((0, pad if k else chunk), (0, 0)))
    kp = av.shape[1]
    nchunks = kp // chunk

    a_v = av.reshape(m, nchunks, chunk).transpose(1, 0, 2)
    a_s = as_.reshape(m, nchunks, chunk).transpose(1, 0, 2)
    b_v = bv.reshape(nchunks, chunk, n)
    b_s = bs.reshape(nchunks, chunk, n)

    i_grid = jax.lax.broadcasted_iota(_iota_np(), (m, chunk, n), 0)
    j_grid = jax.lax.broadcasted_iota(_iota_np(), (m, chunk, n), 2)
    k_local = jax.lax.broadcasted_iota(_iota_np(), (m, chunk, n), 1)

    fn = add.fn if add.fn is not None else (lambda a, b: a)

    def body(carry, xs):
        cv, cs = carry
        avk, ask, bvk, bsk, koff = xs
        pres = ask[:, :, None] & bsk[None, :, :]
        avk_safe = jnp.where(ask, avk, np.asarray(1, avk.dtype)) if getattr(mul.parent, "_needs_safe_fill", False) else avk
        bvk_safe = jnp.where(bsk, bvk, np.asarray(1, bvk.dtype)) if getattr(mul.parent, "_needs_safe_fill", False) else bvk
        prod = _mul_values(avk_safe, bvk_safe, i_grid, k_local + koff, j_grid, mul)
        prod = jnp.broadcast_to(prod, (m, chunk, n)).astype(out_np)
        bv_red, bs_red = _pair_reduce(prod, pres, fn, (1,))
        both = cs & bs_red
        newv = jnp.where(both, fn(cv, bv_red), jnp.where(cs, cv, bv_red))
        return (newv, cs | bs_red), None

    init = (jnp.zeros((m, n), out_np), jnp.zeros((m, n), bool))
    # chunk offsets ride the executed integer width (64-bit contract):
    # astype(int64) under x64-off warns and truncates to int32 anyway
    from ..core import dtypes as _dtm

    _kdt = jnp.int64 if _dtm.executes_64bit() else jnp.int32
    koffs = (jnp.arange(nchunks) * chunk).astype(_kdt)
    (cv, cs), _ = jax.lax.scan(body, init, (a_v, a_s, b_v, b_s, koffs))
    return canonical(cv, cs)


def _s_col(st):
    """struct[:, None] that stays host-side when concrete under a trace."""
    if _host_concrete(st):
        return np.asarray(st)[:, None]
    return st[:, None]


def _s_row(st):
    if _host_concrete(st):
        return np.asarray(st)[None, :]
    return st[None, :]


def _s_take0(st, axis):
    if _host_concrete(st):
        return np.asarray(st)[:, 0] if axis == 1 else np.asarray(st)[0]
    return st[:, 0] if axis == 1 else st[0]


@_jit(static=("semiring", "out_dtype", "strategy"))
def mxv(av, as_, xv, xs, semiring, out_dtype, strategy="auto"):
    """GrB_mxv (reference: core/matrix.py:2203).  Treats v as a column so
    positional multiplies see j = 0."""
    cv, cs = mxm(
        av, as_, tmap(lambda x: x[:, None], xv), _s_col(xs), semiring, out_dtype, strategy
    )
    return tmap(lambda x: x[:, 0], cv), _s_take0(cs, 1)


@_jit(static=("semiring", "out_dtype", "strategy"))
def vxm(xv, xs, bv, bs, semiring, out_dtype, strategy="auto"):
    """GrB_vxm (reference: core/vector.py:1309)."""
    cv, cs = mxm(
        tmap(lambda x: x[None, :], xv), _s_row(xs), bv, bs, semiring, out_dtype, strategy
    )
    return tmap(lambda x: x[0], cv), _s_take0(cs, 0)


@_jit(static=("op", "out_dtype"))
def kronecker(av, as_, bv, bs, op, out_dtype):
    """GrB_kronecker (reference: core/matrix.py:2333)."""
    m, n = av.shape
    p, q = bv.shape
    a_safe = _safe(av, as_, op)
    b_safe = _safe(bv, bs, op)
    prod = op.fn(a_safe[:, None, :, None], b_safe[None, :, None, :])
    pres = as_[:, None, :, None] & bs[None, :, None, :]
    cv = jnp.broadcast_to(prod, (m, p, n, q)).reshape(m * p, n * q).astype(np.dtype(out_dtype.np_type))
    cs = jnp.broadcast_to(pres, (m, p, n, q)).reshape(m * p, n * q)
    return canonical(cv, cs)


# ---------------------------------------------------------------------------
# Extract / assign / build
# ---------------------------------------------------------------------------


@_jit
def extract_matrix(values, struct, rows, cols):
    """GrB_Matrix_extract (reference: core/matrix.py:3051-3087)."""
    v = tmap(lambda a: jnp.take(jnp.take(a, rows, axis=0), cols, axis=1), values)
    s = jnp.take(jnp.take(struct, rows, axis=0), cols, axis=1)
    return v, s


@_jit
def extract_vector(values, struct, idx):
    v = tmap(lambda a: jnp.take(a, idx), values)
    s = jnp.take(struct, idx)
    return v, s


@_jit
def scatter_region_matrix(cv, cs, rows, cols, av, as_):
    """Scatter a region-shaped (av, as_) into C at rows x cols; also returns
    the region-selector bool array (used for assign/subassign semantics,
    reference: core/matrix.py:3116-3529)."""
    zv = tmap(
        lambda c, a: c.at[rows[:, None], cols[None, :]].set(a if _is_soa(cv) else a.astype(c.dtype)),
        cv,
        av,
    )
    if _host_concrete(cs, rows, cols, as_):
        # numpy structure math under traces: jnp ops on concrete arrays bind
        # to the trace in jax 0.9 (constants lift) and would turn the output
        # structure into a tracer, defeating compiled-loop hoisting
        cs_np = np.asarray(cs)
        r_np, c_np = np.asarray(rows), np.asarray(cols)
        zs = cs_np.copy()
        zs[r_np[:, None], c_np[None, :]] = np.asarray(as_)
        rsel = np.zeros(cs_np.shape, bool)
        rsel[r_np[:, None], c_np[None, :]] = True
    else:
        zs = cs.at[rows[:, None], cols[None, :]].set(as_)
        rsel = jnp.zeros(cs.shape, bool).at[rows[:, None], cols[None, :]].set(True)
    return zv, zs, rsel


@_jit
def scatter_region_vector(cv, cs, idx, av, as_):
    zv = tmap(lambda c, a: c.at[idx].set(a if _is_soa(cv) else a.astype(c.dtype)), cv, av)
    if _host_concrete(cs, idx, as_):
        # see scatter_region_matrix: numpy structure math under traces
        cs_np = np.asarray(cs)
        i_np = np.asarray(idx)
        zs = cs_np.copy()
        zs[i_np] = np.asarray(as_)
        rsel = np.zeros(cs_np.shape, bool)
        rsel[i_np] = True
    else:
        zs = cs.at[idx].set(as_)
        rsel = jnp.zeros(cs.shape, bool).at[idx].set(True)
    return zv, zs, rsel


@_jit(static=("start",))
def scatter_region_vector_contig(cv, cs, av, as_, start=0):
    """Contiguous-region variant of ``scatter_region_vector``: slice assigns
    (incl. the ubiquitous ``v(mask)[:] = x``) lower to dynamic_update_slice
    instead of an n-sized XLA scatter."""
    import jax.lax as lax

    zv = tmap(
        lambda c, a: lax.dynamic_update_slice(
            c, a if _is_soa(cv) else a.astype(c.dtype), (start,)
        ),
        cv,
        av,
    )
    if _host_concrete(cs, as_):
        cs_np = np.asarray(cs)
        zs = cs_np.copy()
        zs[start : start + np.asarray(as_).shape[0]] = np.asarray(as_)
    else:
        import jax.lax as lax2

        zs = lax2.dynamic_update_slice(cs, as_, (start,))
    size = as_.shape[0]
    rsel = np.zeros(cs.shape, bool)
    rsel[start : start + size] = True
    return zv, zs, rsel


@_jit(static=("rstart", "cstart"))
def scatter_region_matrix_contig(cv, cs, av, as_, rstart=0, cstart=0):
    """Contiguous 2-D region variant of ``scatter_region_matrix`` (see
    ``scatter_region_vector_contig``)."""
    import jax.lax as lax

    zv = tmap(
        lambda c, a: lax.dynamic_update_slice(
            c, a if _is_soa(cv) else a.astype(c.dtype), (rstart, cstart)
        ),
        cv,
        av,
    )
    nr, nc = as_.shape
    if _host_concrete(cs, as_):
        cs_np = np.asarray(cs)
        zs = cs_np.copy()
        zs[rstart : rstart + nr, cstart : cstart + nc] = np.asarray(as_)
    else:
        zs = lax.dynamic_update_slice(cs, as_, (rstart, cstart))
    rsel = np.zeros(cs.shape, bool)
    rsel[rstart : rstart + nr, cstart : cstart + nc] = True
    return zv, zs, rsel


def _contig_start(idx, dim):
    """Start offset when ``idx`` is a contiguous ascending index range
    (slice-shaped), else None.  idx is host numpy (region indices never ride
    the trace — see the structure-hoisting note at the call site)."""
    k = idx.shape[0]
    if k == 0:
        return None
    start = int(idx[0])
    if int(idx[-1]) - start != k - 1 or start < 0 or start + k > dim:
        return None
    if k > 1 and not bool((np.diff(idx) == 1).all()):
        return None
    return start


# ---------------------------------------------------------------------------
# Mask / accumulator merge: the single sink every mutating op funnels through
# (analogue of BaseType._update -> GrB call, reference: core/base.py:338-514)
# ---------------------------------------------------------------------------


@_jit(static=("accum", "replace", "has_mask"))
def masked_merge(cv, cs, zv, zs, mask_bits, accum, replace, has_mask, region=None):
    """Combine computed result Z into C under mask/accum/replace semantics.

    - accum: None -> Z replaces C's pattern; else accum(C, Z) on intersection,
      pass-through on either-only.
    - mask_bits: bool array (already complemented if needed), or unused when
      has_mask=False.
    - replace: outside-mask entries are cleared (within ``region`` when given,
      GxB_subassign semantics; everywhere for GrB ops).
    - region: bool array limiting where Z applies (assign/subassign); None
      means the whole output.
    """
    if _is_soa(cv):
        if accum is not None:
            both = s_and(cs, zs)
            acc_out = accum.fn(cv, zv)
            zv = {
                key: jnp.where(both, acc_out[key], jnp.where(zs, zv[key], cv[key]))
                for key in cv
            }
            zs = s_or(cs, zs)
    else:
        zv = zv.astype(cv.dtype)
        if accum is not None:
            both = s_and(cs, zs)
            merged = jnp.where(both, accum.fn(cv, zv).astype(cv.dtype), jnp.where(zs, zv, cv))
            zs = s_or(cs, zs)
            zv = merged
    if not has_mask:
        if region is None:
            return canonical(zv, zs)
        # no mask: Z already restricted to region by construction
        return canonical(zv, zs)
    m = mask_bits
    if region is not None:
        # mask applies only within the region; outside-region keeps C
        keep_z = s_and(m, region)
        out_s = s_where(keep_z, zs, s_where(s_and(region, replace), np.zeros((), bool), cs)) if replace else s_where(keep_z, zs, cs)
        out_v = jnp.where(keep_z, zv, cv)
        return canonical(out_v, out_s)
    if replace:
        out_s = s_and(m, zs)
        out_v = tmap(lambda z: jnp.where(m, z, zero_of(z.dtype)), zv)
    else:
        out_s = s_where(m, zs, cs)
        out_v = tmap(lambda z, c: jnp.where(m, z, c), zv, cv)
    return canonical(out_v, out_s)


@_jit(static=("complement", "structural"))
def mask_to_bits(mv, ms, complement, structural):
    """Resolve one of the 4 mask types to a bool array
    (reference mask classes: core/mask.py:133-202)."""
    if structural:
        bits = ms
    else:
        bits = s_and(ms, mv != 0 if mv.dtype != jnp.bool_ else mv)
    if complement:
        bits = s_not(bits)
    return bits


# ---------------------------------------------------------------------------
# Positional / order-based reductions (argmin/argmax/first/last aggregators,
# reference: core/operator/agg.py:535-758)
# ---------------------------------------------------------------------------


@_jit(static=("which", "axis"))
def argminmax_axis(values, struct, which, axis):
    if jnp.issubdtype(values.dtype, jnp.floating):
        big, small = np.inf, -np.inf
    elif values.dtype == jnp.bool_:
        big, small = True, False
    else:
        info = np.iinfo(values.dtype)
        big, small = info.max, info.min
    if which == "min":
        filled = jnp.where(struct, values, jnp.asarray(big, values.dtype))
        idx = jnp.argmin(filled, axis=axis)
    else:
        filled = jnp.where(struct, values, jnp.asarray(small, values.dtype))
        idx = jnp.argmax(filled, axis=axis)
    s = jnp.any(struct, axis=axis)
    # 64-bit contract (docs/types.md): indices ride the platform's executed
    # integer width; astype(int64) under x64-off warns and truncates anyway
    from ..core import dtypes as _dtm

    return idx.astype(jnp.int64 if _dtm.executes_64bit() else jnp.int32), s


@_jit(static=("which", "axis"))
def firstlast_axis(values, struct, which, axis):
    n = struct.shape[axis]
    pos = jax.lax.broadcasted_iota(_iota_np(), struct.shape, axis)
    if which == "first":
        filled = jnp.where(struct, pos, n)
        idx = jnp.min(filled, axis=axis)
    else:
        filled = jnp.where(struct, pos, -1)
        idx = jnp.max(filled, axis=axis)
    s = jnp.any(struct, axis=axis)
    idx = jnp.clip(idx, 0, n - 1)
    vals = jnp.take_along_axis(values, jnp.expand_dims(idx, axis), axis=axis).squeeze(axis)
    return vals, idx, s


# ---------------------------------------------------------------------------
# Misc structure ops
# ---------------------------------------------------------------------------


@_jit
def transpose(values, struct):
    return tmap(lambda a: a.T, values), struct.T


@_jit(static=("row_offset", "col_offset"))
def reposition_matrix(values, struct, row_offset, col_offset):
    """GrB_Matrix_reposition recipe (reference: core/matrix.py:2764-2838)."""
    out_v = jnp.zeros_like(values)
    out_s = jnp.zeros_like(struct)
    # shift via roll + zeroing out-of-range
    rolled_v = jnp.roll(jnp.roll(values, row_offset, axis=0), col_offset, axis=1)
    rolled_s = jnp.roll(jnp.roll(struct, row_offset, axis=0), col_offset, axis=1)
    i, j = _index_grids(values.shape)
    valid = (i >= row_offset if row_offset >= 0 else i < values.shape[0] + row_offset) & (
        j >= col_offset if col_offset >= 0 else j < values.shape[1] + col_offset
    )
    return canonical(jnp.where(valid, rolled_v, out_v), jnp.where(valid, rolled_s, out_s))


@_jit(static=("k",))
def diag_extract(values, struct, k):
    """Extract diagonal k as a vector (reference: Matrix.diag core/matrix.py:720)."""
    v = jnp.diagonal(values, offset=k)
    s = jnp.diagonal(struct, offset=k)
    return v, s


@_jit(static=("k", "nrows", "ncols"))
def diag_build(values, struct, k, nrows, ncols):
    """Build a matrix with vector on diagonal k (reference: gb.ss.diag)."""
    n = values.shape[0]
    out_v = jnp.zeros((nrows, ncols), values.dtype)
    out_s = jnp.zeros((nrows, ncols), bool)
    idx = jnp.arange(n)
    rows = idx + (-k if k < 0 else 0)
    cols = idx + (k if k > 0 else 0)
    out_v = out_v.at[rows, cols].set(values)
    out_s = out_s.at[rows, cols].set(struct)
    return out_v, out_s


@_jit(static=("monoid", "axis"))
def prefix_scan(values, struct, monoid, axis):
    """Prefix scan over present entries along an axis.

    The reference implements this as semiring mxm against synthesized
    selector matrices (core/ss/prefix_scan.py:12-183 — Blelloch sweeps);
    here an ``associative_scan`` of the present-aware monoid is the natural
    lowering.
    """
    fn = monoid.fn if monoid.fn is not None else (lambda a, b: a)

    def comp(a, b):
        va, pa = a
        vb, pb = b
        both = pa & pb
        v = jnp.where(both, fn(va, vb), jnp.where(pb, vb, va))
        return v, pa | pb

    v, s = jax.lax.associative_scan(comp, (values, struct), axis=axis)
    # scan result is present where the original entry was present
    return canonical(v, struct)


@_jit
def flatten_matrix(values, struct):
    return tmap(lambda a: a.reshape(-1), values), struct.reshape(-1)
