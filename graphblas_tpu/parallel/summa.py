"""SUMMA-style sharded semiring matmul + edge-partitioned SpMV.

Design (per SURVEY.md §2.2 north star): dense-masked blocks shard as
P('i', 'j') over a 2-D mesh; C = A ·⊕⊗· B computes local block products and
combines partials across the contraction axis with the semiring's add monoid
— ``lax.psum`` over the mesh when the monoid is plus, ``all_gather`` + on-device
monoid tree otherwise.  Edge-partitioned SpMV shards the edge list across the
whole mesh and psum-combines destination segments.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import densemasked as _dm


def _pad_dim(v, s, axis, mult):
    """Pad (values, struct) along ``axis`` to a multiple of ``mult``.

    Padding carries struct=False, so it is semantically absent — every
    masked-engine op ignores it and the add-monoid combines skip it.
    """
    size = v.shape[axis]
    target = -(-size // mult) * mult
    if target == size:
        return v, s
    widths = [(0, 0)] * v.ndim
    widths[axis] = (0, target - size)
    return jnp.pad(v, widths), jnp.pad(s, widths)


def summa_mxm(A, B, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxm of two dense-masked Matrix objects (see
    summa_mxm_arrays)."""
    return summa_mxm_arrays(
        A._values, A._struct, B._values, B._struct, semiring_typed, out_dtype, mesh,
        axis_names=axis_names,
    )


def summa_mxm_arrays(AV, AS, BV, BS, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxm over dense-masked arrays.

    A shards P(i, j); B shards P(j, None).  Each device computes its local
    (m/pi, k/pj) x (k/pj, n) semiring block product, then partials combine
    over axis j with the add monoid.  Returns (values, struct) sharded P(i,).
    Shapes not divisible by the mesh are padded with absent entries and the
    result is sliced back.
    """
    ai, aj = axis_names
    pi, pj = mesh.shape[ai], mesh.shape[aj]
    m, k = AV.shape
    av, as_ = _pad_dim(*_pad_dim(AV, AS, 0, pi), 1, pj)
    bv, bs = _pad_dim(BV, BS, 0, pj)
    add = semiring_typed.monoid
    add_name = add.parent.name if hasattr(add, "parent") else None
    out_np = np.dtype(out_dtype.np_type)

    from jax import shard_map

    def local(avb, asb, bvb, bsb):
        cv, cs = _dm.mxm(avb, asb, bvb, bsb, semiring_typed, out_dtype)
        if add_name == "plus":
            # absent partials are canonical 0: plain psum is the monoid combine
            cv = jax.lax.psum(jnp.where(cs, cv, jnp.zeros((), cv.dtype)), aj)
            cs = jax.lax.psum(cs.astype(jnp.int32), aj) > 0
            return cv, cs
        # generic monoid: gather partials from the j axis, tree-combine
        all_v = jax.lax.all_gather(cv, aj)  # (pj, mloc, n)
        all_s = jax.lax.all_gather(cs, aj)
        fn = add.fn if add.fn is not None else (lambda a, b: a)

        def comb(x, y):
            xv, xs = x
            yv, ys = y
            both = xs & ys
            return jnp.where(both, fn(xv, yv), jnp.where(xs, xv, yv)), xs | ys

        v, s = all_v[0], all_s[0]
        for t in range(1, all_v.shape[0]):
            v, s = comb((v, s), (all_v[t], all_s[t]))
        return jnp.where(s, v, jnp.zeros((), v.dtype)), s

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(ai, aj), P(ai, aj), P(aj, None), P(aj, None)),
        out_specs=(P(ai, None), P(ai, None)),
        check_vma=False,
    )
    av = jax.device_put(av.astype(semiring_typed.binaryop.type_.np_type), NamedSharding(mesh, P(ai, aj)))
    as_ = jax.device_put(as_, NamedSharding(mesh, P(ai, aj)))
    bv = jax.device_put(bv.astype(semiring_typed.binaryop.type2.np_type), NamedSharding(mesh, P(aj, None)))
    bs = jax.device_put(bs, NamedSharding(mesh, P(aj, None)))
    cv, cs = jax.jit(fn)(av, as_, bv, bs)
    if cv.shape[0] != m:
        cv, cs = cv[:m], cs[:m]
    return cv, cs


def summa_mxv(A, x, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxv (see summa_mxv_arrays)."""
    return summa_mxv_arrays(
        A._values, A._struct, x._values, x._struct, semiring_typed, out_dtype, mesh,
        axis_names=axis_names,
    )


def summa_mxv_arrays(AV, AS, XV, XS, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxv: A P(i, j), x sharded over j; result P(i,).

    Non-divisible shapes are padded with absent entries and sliced back.
    """
    ai, aj = axis_names
    pi, pj = mesh.shape[ai], mesh.shape[aj]
    m = AV.shape[0]
    av_p, as_p = _pad_dim(*_pad_dim(AV, AS, 0, pi), 1, pj)
    xv_p, xs_p = _pad_dim(XV, XS, 0, pj)
    from jax import shard_map

    add = semiring_typed.monoid
    add_name = add.parent.name if hasattr(add, "parent") else None

    def local(avb, asb, xvb, xsb):
        cv, cs = _dm.mxv(avb, asb, xvb, xsb, semiring_typed, out_dtype)
        if add_name == "plus":
            cv = jax.lax.psum(jnp.where(cs, cv, jnp.zeros((), cv.dtype)), aj)
            cs = jax.lax.psum(cs.astype(jnp.int32), aj) > 0
            return cv, cs
        all_v = jax.lax.all_gather(cv, aj)
        all_s = jax.lax.all_gather(cs, aj)
        fn = add.fn if add.fn is not None else (lambda a, b: a)
        v, s = all_v[0], all_s[0]
        for t in range(1, all_v.shape[0]):
            both = s & all_s[t]
            v = jnp.where(both, fn(v, all_v[t]), jnp.where(s, v, all_v[t]))
            s = s | all_s[t]
        return jnp.where(s, v, jnp.zeros((), v.dtype)), s

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(ai, aj), P(ai, aj), P(aj), P(aj)),
        out_specs=(P(ai), P(ai)),
        check_vma=False,
    )
    av = jax.device_put(
        av_p.astype(semiring_typed.binaryop.type_.np_type), NamedSharding(mesh, P(ai, aj))
    )
    as_ = jax.device_put(as_p, NamedSharding(mesh, P(ai, aj)))
    xv = jax.device_put(xv_p.astype(semiring_typed.binaryop.type2.np_type), NamedSharding(mesh, P(aj)))
    xs = jax.device_put(xs_p, NamedSharding(mesh, P(aj)))
    yv, ys = jax.jit(fn)(av, as_, xv, xs)
    if yv.shape[0] != m:
        yv, ys = yv[:m], ys[:m]
    return yv, ys


def sharded_spmv_step(mesh, n, *, axis_names=("i", "j")):
    """Build a jitted edge-partitioned plus_times SpMV step over the mesh.

    Edge arrays shard across ALL devices (flattened mesh); x replicates; each
    device segment-sums its local edges and partial results psum over the
    mesh — the O(E) analogue of SUMMA for irregular graphs.  Returns a
    function (src, dst, w, valid, x) -> y with shardings baked in.
    """
    from jax import shard_map

    both = axis_names

    def local(src, dst, w, valid, x):
        contrib = jnp.where(valid, w * x[src], 0)
        part = jax.ops.segment_sum(contrib, dst, num_segments=n)
        return jax.lax.psum(part, both)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(both), P(both), P(both), P(both), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)
