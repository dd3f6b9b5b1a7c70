"""Shared expression builders for Matrix and Vector.

Each builder returns a BaseExpression whose compute closure calls the engine
(ops/densemasked).  This is the layer where the reference picks a
``cfunc_name`` (e.g. "GrB_Matrix_eWiseMult_BinaryOp",
/root/reference/graphblas/core/matrix.py:1952-2042); here it binds typed JAX
ops into engine closures.
"""

import numpy as np

from .. import exceptions as _exc
from ..ops import densemasked as _dm
from . import dtypes as _dt
from .base import BaseExpression
from .operator import find_opclass, get_typed_op
from .scalar import Scalar, _as_scalar, _is_scalar_like


def _arrays_of(obj):
    return obj._values, obj._struct


def _mesh_context():
    """The engaged parallel.Context, if any (thread-local stack)."""
    try:
        from ..parallel import current_context
    except ImportError:  # pragma: no cover
        return None
    return current_context()


def _sparse_of(obj):
    """(SparseMatrixData, is_transposed) for sparse-format operands, else (None, False)."""
    from .matrix import TransposedMatrix
    from .sparse import SparseMatrixData

    if isinstance(obj, TransposedMatrix):
        sp = getattr(obj._matrix, "_sparse", None)
    else:
        sp = getattr(obj, "_sparse", None)
    if not isinstance(sp, SparseMatrixData):
        return None, False
    return sp, isinstance(obj, TransposedMatrix)


def _sp_nonudt(sp):
    """True for sparse data whose values support device kernels (non-UDT);
    UDT sparse supports pattern surgery + ewise, not the value kernels."""
    return sp is not None and sp.vals.dtype.names is None


def _vec_sparse_of(obj):
    """SparseVectorData for sparse-format Vector operands, else None."""
    from .sparse import SparseVectorData

    sv = getattr(obj, "_sparse", None)
    return sv if isinstance(sv, SparseVectorData) else None


def _to_sv(vec):
    """SparseVectorData view of any Vector (host conversion when dense)."""
    from .sparse import SparseVectorData

    sv = _vec_sparse_of(vec)
    if sv is not None:
        return sv
    idx, vals = vec.to_coo()
    return SparseVectorData(idx.astype(np.int64), vals, vec.size)


def _cast_values(v, np_type, dtype):
    """Cast engine values to an op's input dtype; UDTs are never cast.
    Device values cast at the EXECUTED width (64-bit contract: astype to a
    64-bit dtype under a 32-bit policy warns and truncates anyway)."""
    if dtype._is_udt or isinstance(v, dict):
        return v
    if isinstance(v, np.ndarray):
        return v.astype(np_type)
    from . import dtypes as _dtm

    return v.astype(_dtm.executed_np(np_type))


def _check_same_shape(a, b, within):
    if a.shape != b.shape:
        raise _exc.DimensionMismatch(
            f"Dimensions not compatible in {within}: {a.shape} != {b.shape}"
        )


def ewise_expr(self, other, op, how, *, left_default=None, right_default=None):
    """eWiseAdd / eWiseMult / eWiseUnion (reference: core/matrix.py:1861-2202)."""
    from .matrix import Matrix, TransposedMatrix
    from .vector import Vector

    other = self._expect_type(
        other,
        (Matrix, TransposedMatrix, Vector),
        within=f"ewise_{how}",
        argname="other",
    )
    # edge-layout loop body: lift a concrete n-sized operand (a closed-over
    # static like a degree vector) to the edge layout of the state operand
    from . import looplayout as _ll

    _lctx = _ll.active()
    if _lctx is not None and self.ndim == 1 and other.ndim == 1:
        if _lctx.is_state_sized(self) and _lctx.is_n_sized(other):
            other = _lctx.lift_vector(other)
        elif _lctx.is_n_sized(self) and _lctx.is_state_sized(other):
            self = _lctx.lift_vector(self)
    # mixed-rank broadcast recipes (reference: core/vector.py:47-67 _v_add_m/
    # _v_mult_m and core/matrix.py:63-86 _m_add_v/_m_mult_v): a Vector on the
    # left broadcasts v[i] across row i; on the right, v[j] across column j.
    vec_left = vec_right = False
    if other.ndim != self.ndim:
        if self.ndim == 1 and other.ndim == 2:
            if self.shape[0] != other.shape[0]:
                raise _exc.DimensionMismatch(
                    f"ewise_{how} broadcast: vector size {self.shape[0]} != nrows {other.shape[0]}"
                )
            vec_left = True
        else:
            if other.shape[0] != self.shape[1]:
                raise _exc.DimensionMismatch(
                    f"ewise_{how} broadcast: vector size {other.shape[0]} != ncols {self.shape[1]}"
                )
            vec_right = True
        out_shape = other.shape if vec_left else self.shape
    else:
        _check_same_shape(self, other, f"ewise_{how}")
        out_shape = self.shape
    op_t = get_typed_op(op, self.dtype, other.dtype, kind="binary")
    _, opclass = find_opclass(op_t)
    if opclass == "Semiring":
        # reference allows semirings in ewise by taking the multiply op for
        # mult and the add monoid for add
        op_t = op_t.binaryop if how == "mult" else op_t.monoid
    out_cls = Matrix if len(out_shape) == 2 else Vector

    def _operands():
        import jax.numpy as jnp

        av, as_ = _arrays_of(self)
        bv, bs = _arrays_of(other)
        av = _cast_values(av, op_t.type_.np_type, self.dtype)
        bv = _cast_values(bv, op_t.type2.np_type, other.dtype)
        if vec_left:
            av = _dm.tmap(lambda x: jnp.broadcast_to(x[:, None], out_shape), av)
            as_ = jnp.broadcast_to(as_[:, None], out_shape)
        elif vec_right:
            bv = _dm.tmap(lambda x: jnp.broadcast_to(x[None, :], out_shape), bv)
            bs = jnp.broadcast_to(bs[None, :], out_shape)
        return av, as_, bv, bs

    if how == "union":
        ld = _as_scalar(left_default)
        rd = _as_scalar(right_default)

        def compute():
            av, as_, bv, bs = _operands()
            return _dm.ewise_union(av, as_, bv, bs, op_t, ld._device_value(op_t.type_.np_type), rd._device_value(op_t.type2.np_type))

    else:
        engine = _dm.ewise_mult if how == "mult" else _dm.ewise_add

        def compute():
            av, as_, bv, bs = _operands()
            return engine(av, as_, bv, bs, op_t)

    # sparse-sparse ewise: host merge-join + device combine, no densify
    # (keeps 2^60-scale dimensions representable — reference hypersparse,
    # graphblas/__init__.py:210-213)
    sparse_fn = None
    if self.ndim == 1 and other.ndim == 1:
        a_sv = _vec_sparse_of(self)
        b_sv = _vec_sparse_of(other)
        if a_sv is not None or b_sv is not None:

            def sparse_fn():
                from .sparse import sparse_vec_ewise
                from .vector import Vector

                asv = _to_sv(self)
                bsv = _to_sv(other)
                if how == "union":
                    ldv = np.asarray(ld.value if hasattr(ld, "value") else ld)[()]
                    rdv = np.asarray(rd.value if hasattr(rd, "value") else rd)[()]
                    sv2 = sparse_vec_ewise(asv, bsv, op_t, "union", op_t.return_type, ld=ldv, rd=rdv)
                else:
                    sv2 = sparse_vec_ewise(asv, bsv, op_t, how, op_t.return_type)
                return Vector._from_sparse(sv2, op_t.return_type)

    if self.ndim == 2 and other.ndim == 2:
        a_sp, a_t = _sparse_of(self)
        b_sp, b_t = _sparse_of(other)
        if a_sp is not None and b_sp is not None:

            def sparse_fn():
                from .sparse import sparse_ewise

                asp = a_sp.transposed() if a_t else a_sp
                bsp = b_sp.transposed() if b_t else b_sp
                if how == "union":
                    ldv = np.asarray(ld.value if hasattr(ld, "value") else ld)[()]
                    rdv = np.asarray(rd.value if hasattr(rd, "value") else rd)[()]
                    sp2 = sparse_ewise(asp, bsp, op_t, "union", op_t.return_type, ld=ldv, rd=rdv)
                else:
                    sp2 = sparse_ewise(asp, bsp, op_t, how, op_t.return_type)
                return Matrix._from_sparse(sp2, op_t.return_type)

    return BaseExpression(
        f"ewise_{how}",
        out_cls,
        compute,
        op=op_t,
        dtype=op_t.return_type,
        shape=out_shape,
        args=(self, other),
        opname=f"ewise_{how}[{op_t.name}]",
        sparse_compute=sparse_fn,
    )


def apply_expr(self, op, right=None, *, left=None, thunk=None):
    """GrB_apply: unary / bound-binary / indexunary+thunk
    (reference: core/matrix.py:2375-2533)."""
    from .matrix import Matrix
    from .vector import Vector

    out_cls = Matrix if self.ndim == 2 else Vector
    op_resolved, opclass = find_opclass(op if not isinstance(op, str) else None)
    if isinstance(op, str):
        from .operator.utils import resolve_op_string

        # a string + second positional arg may name an indexunary op with a
        # thunk, e.g. v.apply("rowindex", 0) (reference apply string dispatch)
        if right is not None and thunk is None:
            try:
                op = resolve_op_string(op, "indexunary")
                right, thunk = None, right
            except ValueError:
                op = get_typed_op(op, self.dtype, kind="unary|binary")
        else:
            op = get_typed_op(op, self.dtype, kind="unary|binary")
        op_resolved, opclass = find_opclass(op)

    if opclass in {"IndexUnaryOp", "SelectOp"}:
        from . import looplayout as _ll

        _ll.reject_index_semantics(self, op, "indexunary apply")
        if opclass == "SelectOp":
            # reference lifts SelectOp to its IndexUnaryOp for apply
            op = op._iu if hasattr(op, "_iu") and op._iu is not None else op
        if left is not None:
            raise TypeError("left= is not allowed for IndexUnaryOp apply; pass the thunk")
        if right is not None:
            # reference convention: the thunk rides the ``right`` slot for
            # indexunary apply (A.apply(indexunary.tril, 2))
            if thunk is not None:
                raise TypeError("pass the IndexUnaryOp thunk as either right or thunk, not both")
            thunk = right
        op_t = get_typed_op(op, self.dtype, kind="indexunary")
        thunk_s = _as_scalar(thunk if thunk is not None else 0, getattr(op_t.parent, "_thunk_dtype", None))

        def compute():
            v, s = _arrays_of(self)
            v = _cast_values(v, op_t.type_.np_type, self.dtype)
            return _dm.apply_indexunary(v, s, op_t, thunk_s._device_value())

        sparse_fn = None
        sp, transposed = _sparse_of(self)
        sv = _vec_sparse_of(self)
        if _sp_nonudt(sp) and not transposed:

            def sparse_fn():
                from .matrix import Matrix
                from .sparse import sparse_apply_indexunary

                sp2 = sparse_apply_indexunary(
                    sp, op_t, thunk_s._device_value(), np.dtype(op_t.return_type.np_type)
                )
                return Matrix._from_sparse(sp2, op_t.return_type)

        elif sv is not None:

            def sparse_fn():
                from .sparse import sparse_vec_apply_indexunary
                from .vector import Vector

                sv2 = sparse_vec_apply_indexunary(
                    sv, op_t, thunk_s._device_value(), np.dtype(op_t.return_type.np_type)
                )
                return Vector._from_sparse(sv2, op_t.return_type)

        return BaseExpression(
            "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]", sparse_compute=sparse_fn
        )

    if right is None and left is None and thunk is None:
        op_t = get_typed_op(op, self.dtype, kind="unary")
        _, opclass2 = find_opclass(op_t)
        if opclass2 == "BinaryOp":
            raise TypeError(
                f"Binary op {op_t.name} passed to apply without left or right; "
                "provide `left=` or `right=` to bind one argument"
            )
        sp, transposed = _sparse_of(self)
        sv = _vec_sparse_of(self)
        sparse_fn = None
        if getattr(op_t, "positional", None) is not None:
            from . import looplayout as _ll

            _ll.reject_index_semantics(self, op_t, "positional apply")

            def compute():
                v, s = _arrays_of(self)
                return _dm.apply_positional_unary(v, s, op_t, 0)

            if _sp_nonudt(sp) and not transposed:

                def sparse_fn():
                    from .matrix import Matrix
                    from .sparse import sparse_apply_positional

                    pos = op_t.positional
                    which, delta = pos if not isinstance(pos, str) else (pos, 0)
                    sp2 = sparse_apply_positional(
                        sp, which, delta, np.dtype(op_t.return_type.np_type)
                    )
                    return Matrix._from_sparse(sp2, op_t.return_type)

            elif sv is not None:

                def sparse_fn():
                    from .sparse import sparse_vec_apply_positional
                    from .vector import Vector

                    pos = op_t.positional
                    which, delta = pos if not isinstance(pos, str) else (pos, 0)
                    sv2 = sparse_vec_apply_positional(
                        sv, which, delta, np.dtype(op_t.return_type.np_type)
                    )
                    return Vector._from_sparse(sv2, op_t.return_type)

        else:
            def compute():
                v, s = _arrays_of(self)
                v = _cast_values(v, op_t.type_.np_type, self.dtype)
                return _dm.apply_unary(v, s, op_t)

            if _sp_nonudt(sp) and not transposed:

                def sparse_fn():
                    from .matrix import Matrix
                    from .sparse import sparse_apply_values

                    in_np = np.dtype(op_t.type_.np_type)
                    sp2 = sparse_apply_values(
                        sp,
                        lambda v: op_t.fn(v.astype(in_np)),
                        np.dtype(op_t.return_type.np_type),
                    )
                    return Matrix._from_sparse(sp2, op_t.return_type)

            elif sv is not None:

                def sparse_fn():
                    from .sparse import sparse_vec_apply_values
                    from .vector import Vector

                    in_np = np.dtype(op_t.type_.np_type)
                    sv2 = sparse_vec_apply_values(
                        sv,
                        lambda v: op_t.fn(v.astype(in_np)),
                        np.dtype(op_t.return_type.np_type),
                    )
                    return Vector._from_sparse(sv2, op_t.return_type)

        return BaseExpression(
            "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]", sparse_compute=sparse_fn
        )

    if right is not None and left is not None:
        raise TypeError("Cannot provide both `left` and `right` to apply")
    bound = right if right is not None else left
    if not _is_scalar_like(bound) and not isinstance(bound, Scalar):
        raise TypeError(f"`{'right' if right is not None else 'left'}` must be a scalar; got {type(bound)}")
    bound = _as_scalar(bound)
    if right is not None:
        op_t = get_typed_op(op, self.dtype, bound.dtype, is_right_scalar=True, kind="binary")
    else:
        op_t = get_typed_op(op, bound.dtype, self.dtype, is_left_scalar=True, kind="binary")

    def compute():
        v, s = _arrays_of(self)
        v = _cast_values(
            v, op_t.type_.np_type if right is not None else op_t.type2.np_type, self.dtype
        )
        b = bound._device_value(op_t.type2.np_type if right is not None else op_t.type_.np_type)
        return _dm.apply_bound(v, s, op_t, b, "right" if right is not None else "left")

    sparse_fn = None
    sp, transposed = _sparse_of(self)
    sv = _vec_sparse_of(self)
    if (_sp_nonudt(sp) and not transposed or sv is not None) and getattr(op_t, "positional", None) is None:

        def sparse_fn():
            from .matrix import Matrix
            from .sparse import sparse_apply_values, sparse_vec_apply_values
            from .vector import Vector

            in_np = np.dtype((op_t.type_ if right is not None else op_t.type2).np_type)
            b = bound._device_value(
                (op_t.type2 if right is not None else op_t.type_).np_type
            )
            if right is not None:
                fn = lambda v: op_t.fn(v.astype(in_np), b)  # noqa: E731
            else:
                fn = lambda v: op_t.fn(b, v.astype(in_np))  # noqa: E731
            if sv is not None:
                sv2 = sparse_vec_apply_values(sv, fn, np.dtype(op_t.return_type.np_type))
                return Vector._from_sparse(sv2, op_t.return_type)
            sp2 = sparse_apply_values(sp, fn, np.dtype(op_t.return_type.np_type))
            return Matrix._from_sparse(sp2, op_t.return_type)

    return BaseExpression(
        "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]", sparse_compute=sparse_fn
    )


def select_expr(self, op, thunk=None):
    """GrB_select (reference: core/matrix.py:2534-2635).

    Besides SelectOps and comparison strings, accepts a Mask or a boolean
    collection/expression (reference: core/vector.py:1565-1596): entries of
    ``self`` are kept where the mask is true.
    """
    from .expr import AmbiguousAssignOrExtract
    from .mask import Mask, ValueMask
    from .matrix import Matrix, TransposedMatrix
    from .vector import Vector

    if isinstance(op, str) and any(c in op for c in "<>=!"):
        if thunk is None:
            op, thunk = _parse_select_string(op)
        else:
            op = _bare_select_op(op)
    mask_obj = None
    if isinstance(op, Mask):
        mask_obj = op
    elif isinstance(op, (BaseExpression, AmbiguousAssignOrExtract, TransposedMatrix)):
        mask_obj = ValueMask(op.new())
    elif isinstance(op, (Vector, Matrix)):
        mask_obj = ValueMask(op)
    if mask_obj is not None:
        if thunk is not None:
            raise TypeError(
                "thunk argument not None when calling select with mask or boolean object"
            )
        if mask_obj.parent.shape != self.shape:
            raise _exc.DimensionMismatch(
                f"select mask shape {mask_obj.parent.shape} != {self.shape}"
            )
        out_cls_m = Matrix if self.ndim == 2 else Vector

        def compute_mask():
            import jax.numpy as jnp

            v, s = _arrays_of(self)
            keep = s & mask_obj._bits()
            vv = _dm.tmap(lambda a: jnp.where(keep, a, jnp.zeros_like(a)), v)
            return vv, keep

        return BaseExpression(
            "select",
            out_cls_m,
            compute_mask,
            op=None,
            dtype=self.dtype,
            shape=self.shape,
            args=(self,),
            opname="select[mask]",
        )
    out_cls = Matrix if self.ndim == 2 else Vector
    op_t = get_typed_op(op, self.dtype, kind="select")
    from . import looplayout as _ll

    _ll.reject_index_semantics(self, op_t, "select")
    thunk_s = _as_scalar(thunk if thunk is not None else 0, getattr(op_t.parent, "_thunk_dtype", None))

    def compute():
        v, s = _arrays_of(self)
        return _dm.select_op(v, s, op_t, thunk_s._device_value())

    sparse_fn = None
    sp, transposed = _sparse_of(self)
    sv = _vec_sparse_of(self)
    if _sp_nonudt(sp) and not transposed:

        def sparse_fn():
            from .matrix import Matrix
            from .sparse import sparse_select

            sp2 = sparse_select(sp, op_t, thunk_s._device_value())
            return Matrix._from_sparse(sp2, self.dtype)

    elif sv is not None:

        def sparse_fn():
            from .sparse import sparse_vec_select
            from .vector import Vector

            sv2 = sparse_vec_select(sv, op_t, thunk_s._device_value())
            return Vector._from_sparse(sv2, self.dtype)

    return BaseExpression(
        "select", out_cls, compute, op=op_t, dtype=self.dtype, shape=self.shape, args=(self,), opname=f"select[{op_t.name}]", sparse_compute=sparse_fn
    )


def _parse_select_string(string):
    """Support e.g. select("value <= 5") / select(">0") shorthand
    (reference accepts comparison strings in select)."""
    import re

    s = string.replace("value", "").strip()
    m = re.match(r"(==|!=|<=|>=|<|>)\s*(.+)", s)
    if m is None:
        raise ValueError(f"Invalid select string: {string!r}")
    cmp_map = {"==": "valueeq", "!=": "valuene", "<": "valuelt", "<=": "valuele", ">": "valuegt", ">=": "valuege"}
    thunk = float(m.group(2)) if "." in m.group(2) or "e" in m.group(2).lower() else int(m.group(2))
    import graphblas_tpu.select as select_mod

    return getattr(select_mod, cmp_map[m.group(1)]), thunk


def _bare_select_op(string):
    """Comparison string with the thunk passed separately: select("==", 1),
    select("index<", 4), select("row<=", 2) (reference select.from_string)."""
    import re

    m = re.match(r"(value|index|row|col|column)?\s*(==|!=|<=|>=|<|>)$", string.strip())
    if m is None:
        raise ValueError(f"Unknown op string for kind=select: {string!r}")
    prefix = {None: "value", "value": "value", "index": "index", "row": "row", "col": "col", "column": "col"}[m.group(1)]
    suffix = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}[m.group(2)]
    import graphblas_tpu.select as select_mod

    return getattr(select_mod, prefix + suffix)


def reduce_axis_expr(self, monoid, axis, method_name):
    """reduce_rowwise/columnwise (reference: core/matrix.py:2636-2735)."""
    from .vector import Vector

    monoid_t, opclass = _resolve_reduce_op(monoid, self.dtype)
    out_size = self.shape[0] if axis == 1 else self.shape[1]
    if opclass == "Aggregator":
        return BaseExpression(
            method_name, Vector, None, op=monoid_t, dtype=monoid_t.return_type, shape=(out_size,), args=(self,), opname=method_name
        )

    sp, transposed = _sparse_of(self)
    if _sp_nonudt(sp):
        sp_axis = (1 - axis) if transposed else axis

        def compute():
            from .sparse import sparse_reduce_axis

            return sparse_reduce_axis(sp, monoid_t, sp_axis)

    else:

        def compute():
            v, s = _arrays_of(self)
            v = _cast_values(v, monoid_t.type_.np_type, self.dtype)
            return _dm.reduce_axis(v, s, monoid_t, axis)

    return BaseExpression(
        method_name, Vector, compute, op=monoid_t, dtype=monoid_t.return_type, shape=(out_size,), args=(self,), opname=f"{method_name}[{monoid_t.name}]"
    )


def reduce_scalar_expr(self, monoid, allow_empty, method_name="reduce_scalar"):
    """reduce to Scalar (reference: core/matrix.py:2712-2763)."""
    monoid_t, opclass = _resolve_reduce_op(monoid, self.dtype)
    if opclass == "Aggregator":
        return BaseExpression(
            method_name, Scalar, None, op=monoid_t, dtype=monoid_t.return_type, shape=(), args=(self,), opname=method_name
        )

    sp, _ = _sparse_of(self)
    sv = _vec_sparse_of(self)

    def compute():
        if sv is not None:
            from .sparse import sparse_vec_reduce_scalar

            val, present = sparse_vec_reduce_scalar(sv, monoid_t)
        elif _sp_nonudt(sp):
            from .sparse import sparse_reduce_scalar

            val, present = sparse_reduce_scalar(sp, monoid_t)
        else:
            v, s = _arrays_of(self)
            v = _cast_values(v, monoid_t.type_.np_type, self.dtype)
            val, present = _dm.reduce_all(v, s, monoid_t)
        if not allow_empty:
            import jax.numpy as jnp

            ident = monoid_t.identity
            if ident is not None:
                val = jnp.where(present, val, jnp.asarray(ident, val.dtype))
            present = jnp.asarray(True)
        return val, present

    return BaseExpression(
        method_name, Scalar, compute, op=monoid_t, dtype=monoid_t.return_type, shape=(), args=(self,), opname=f"{method_name}[{monoid_t.name}]"
    )


def _resolve_reduce_op(monoid, dtype):
    from .operator.agg import Aggregator, TypedAggregator

    if isinstance(monoid, (Aggregator, TypedAggregator)):
        return monoid[dtype] if isinstance(monoid, Aggregator) else monoid, "Aggregator"
    if isinstance(monoid, str):
        monoid = get_typed_op(monoid, dtype, kind="binary|aggregator")
        _, opclass = find_opclass(monoid)
        if opclass == "Aggregator":
            return monoid, "Aggregator"
    monoid_t = get_typed_op(monoid, dtype, kind="monoid")
    _, opclass = find_opclass(monoid_t)
    if opclass == "BinaryOp":
        parent_monoid = monoid_t.monoid
        if parent_monoid is None:
            raise _exc.DomainMismatch(f"BinaryOp {monoid_t.name} has no corresponding monoid for reduce")
        monoid_t = parent_monoid
        opclass = "Monoid"
    if opclass == "Aggregator":
        return monoid_t, "Aggregator"
    return monoid_t, opclass


def mxm_expr(a, b, semiring_op, method_name="mxm"):
    """GrB_mxm / mxv / vxm (reference: core/matrix.py:2203-2331)."""
    from .matrix import Matrix, TransposedMatrix
    from .vector import Vector

    a_is_vec = a.ndim == 1
    b_is_vec = b.ndim == 1
    k1 = a.shape[0] if a_is_vec else a.shape[1]
    k2 = b.shape[0]
    # edge-layout loop body (core/looplayout.py): a state vector of virtual
    # size n is carried as an e_pad array; the SpMV accepts it directly
    from . import looplayout as _ll

    _lctx = _ll.active()
    _edge_vec = (
        _lctx is not None
        and (a_is_vec ^ b_is_vec)
        and (a if a_is_vec else b).shape[0] == _lctx.e_pad
    )
    if _edge_vec:
        k1 = k2 = _lctx.n
    if k1 != k2:
        raise _exc.DimensionMismatch(
            f"Dimensions not compatible for {method_name}: inner dims {k1} != {k2}"
        )
    sr = get_typed_op(semiring_op, a.dtype, b.dtype, kind="semiring")
    _, opclass = find_opclass(sr)
    if opclass == "BinaryOp":
        raise TypeError(f"{method_name} requires a Semiring; got BinaryOp {sr.name}. Maybe use a monoid_binaryop name.")
    if a_is_vec and b_is_vec:
        out_cls, shape = Scalar, ()
    elif a_is_vec:
        out_cls, shape = Vector, (b.shape[1],)
    elif b_is_vec:
        out_cls, shape = Vector, (a.shape[0],)
    else:
        out_cls, shape = Matrix, (a.shape[0], b.shape[1])
    if _edge_vec:
        # the edge-layout SpMV's output stays in the edge space
        shape = (_lctx.e_pad,)

    # sparse matrix-vector products run the O(E) sparse engine (fastspmv plan
    # or gather+segment generic path) — never densifying the matrix
    a_sp, a_t = _sparse_of(a) if not a_is_vec else (None, False)
    b_sp, b_t = _sparse_of(b) if not b_is_vec else (None, False)
    sparse_mv = None
    msp = vec = pull_dir = a_first = None
    if _sp_nonudt(a_sp) and b_is_vec:
        # GrB_mxv: y = A (.) x ; A.T flips to the push direction
        msp, vec, pull_dir, a_first = a_sp, b, not a_t, True
    elif _sp_nonudt(b_sp) and a_is_vec:
        # GrB_vxm: w = x (.) A ; the vector is the op's first arg
        msp, vec, pull_dir, a_first = b_sp, a, b_t, False

    if msp is not None:
        from .sparse import _dense_limit

        vec_sv = _vec_sparse_of(vec)
        n_out = shape[0]
        out_sparse = n_out > _dense_limit() and not _edge_vec
        if vec_sv is not None or out_sparse:
            # sparse vector operand and/or huge output dimension: the host
            # O(E log nnz(x)) join path produces a SPARSE vector — nothing
            # densifies at any dimension (reference hypersparse semantics)
            def sv_compute():
                from .sparse import (
                    SparseVectorData,
                    _densify_limit,
                    sparse_mxv,
                    sparse_mxv_sv,
                )
                from .vector import Vector

                ctx = _mesh_context()
                if (
                    ctx is not None
                    and vec.size <= _densify_limit()
                    and n_out <= _densify_limit()
                ):
                    # engaged mesh Context: densify x and run the device
                    # (sharded-plan) engine, then re-sparsify the output
                    xv, xs = _to_sv(vec).densify(np.dtype(sr.binaryop.type2.np_type if a_first else sr.binaryop.type_.np_type))
                    yv, ys = sparse_mxv(msp, pull_dir, a_first, xv, xs, sr, sr.return_type)
                    keep = np.asarray(ys)
                    idx = np.flatnonzero(keep)
                    sv2 = SparseVectorData(
                        idx.astype(np.int64), np.asarray(yv)[idx], n_out
                    )
                    return Vector._from_sparse(sv2, sr.return_type)
                sv2 = sparse_mxv_sv(msp, pull_dir, a_first, _to_sv(vec), sr, sr.return_type)
                return Vector._from_sparse(sv2, sr.return_type)

            def compute_dense():
                out = sv_compute()
                return out._sparse.densify(np.dtype(sr.return_type.np_type))

            return BaseExpression(
                method_name,
                out_cls,
                compute_dense,
                op=sr,
                dtype=sr.return_type,
                shape=shape,
                args=(a, b),
                opname=f"{method_name}[{sr.name}]",
                sparse_compute=sv_compute if out_sparse else None,
            )

        def sparse_mv():  # dense vector in, dense (n_out,) out: device engine
            from .sparse import sparse_mxv

            xv, xs = _arrays_of(vec)
            return sparse_mxv(msp, pull_dir, a_first, xv, xs, sr, sr.return_type)

    if sparse_mv is not None:
        return BaseExpression(
            method_name,
            out_cls,
            sparse_mv,
            op=sr,
            dtype=sr.return_type,
            shape=shape,
            args=(a, b),
            opname=f"{method_name}[{sr.name}]",
        )

    if _sp_nonudt(a_sp) and _sp_nonudt(b_sp) and not a_is_vec and not b_is_vec:
        def _operand_sps():
            return (a_sp.transposed() if a_t else a_sp), (b_sp.transposed() if b_t else b_sp)

        # masked sparse SpGEMM: consumed by _update when C(M) << A.mxm(B)
        # (reference: masked dot method, core/ss/descriptor.py:76-82)
        def sparse_masked_mxm(mask):
            from .matrix import Matrix
            from .sparse import SparseMatrixData, sparse_mxm_masked

            mp = mask.parent
            if mp.ndim != 2 or mp.shape != shape:
                return None
            mr, mc, mv = mp.to_coo()
            if not mask.structure:
                keep = np.asarray(mv).astype(bool)
                mr, mc = mr[keep], mc[keep]
            asp, bsp = _operand_sps()
            ctx = _mesh_context()
            if ctx is not None and ctx.mesh.devices.size > 1:
                # engaged mesh: distribute by mask-row blocks (one
                # independent plan per device — parallel/spgemm.py)
                from ..parallel.spgemm import sharded_masked_mxm_arrays

                rows, cols, vals, flops = sharded_masked_mxm_arrays(
                    asp, bsp, mr.astype(np.int64), mc.astype(np.int64),
                    sr, sr.return_type, ctx,
                )
            else:
                rows, cols, vals, flops = sparse_mxm_masked(
                    asp, bsp, mr.astype(np.int64), mc.astype(np.int64), sr, sr.return_type
                )
            sp = SparseMatrixData.from_arrays(
                rows, cols, vals, shape[0], shape[1], sorted_dedup=True
            )
            return Matrix._from_sparse(sp, sr.return_type)

        # unmasked sparse x sparse: sparse OUTPUT via the host Gustavson
        # expand-join (reference: GrB_mxm always yields sparse output,
        # core/matrix.py:2264-2331)
        def sparse_full_mxm():
            from .matrix import Matrix
            from .sparse import sparse_spgemm_full

            asp, bsp = _operand_sps()
            sp2 = sparse_spgemm_full(asp, bsp, sr, sr.return_type)
            return Matrix._from_sparse(sp2, sr.return_type)

        expr = BaseExpression(
            method_name,
            out_cls,
            None,  # dense compute defined below; reassigned after creation
            op=sr,
            dtype=sr.return_type,
            shape=shape,
            args=(a, b),
            opname=f"{method_name}[{sr.name}]",
            sparse_compute=sparse_full_mxm,
        )
        expr._sparse_masked_mxm = sparse_masked_mxm

        def compute_spgemm_dense():
            av, as_ = _arrays_of(a)  # densify-guarded fallback
            bv, bs = _arrays_of(b)
            av = _cast_values(av, sr.binaryop.type_.np_type, a.dtype)
            bv = _cast_values(bv, sr.binaryop.type2.np_type, b.dtype)
            return _dm.mxm(av, as_, bv, bs, sr, sr.return_type, "auto")

        expr._compute_fn = compute_spgemm_dense
        return expr

    def compute():
        from ..tx import config as _txconfig

        # read at compute time so per-call descriptor opts (applied as a
        # config context by BaseType._update) take effect; passed statically
        strategy = _txconfig.get("mxm_strategy", "auto")
        av, as_ = _arrays_of(a)
        bv, bs = _arrays_of(b)
        av = _cast_values(av, sr.binaryop.type_.np_type, a.dtype)
        bv = _cast_values(bv, sr.binaryop.type2.np_type, b.dtype)
        # inside an engaged mesh Context, dense matrix products run SUMMA
        # over the mesh collectives (reference Context semantics:
        # core/ss/context.py:19-151 scope resources; here the resource is
        # the device mesh — SURVEY §2.2 north star)
        ctx = _mesh_context()
        if (
            ctx is not None
            and not isinstance(av, dict)
            and not isinstance(bv, dict)
            and not (a_is_vec and b_is_vec)
        ):
            from ..parallel.summa import summa_mxm_arrays, summa_mxv_arrays

            if not a_is_vec and not b_is_vec:
                return summa_mxm_arrays(av, as_, bv, bs, sr, sr.return_type, ctx.mesh)
            if b_is_vec:
                return summa_mxv_arrays(av, as_, bv, bs, sr, sr.return_type, ctx.mesh)
            # vxm: run as mxv of B^T — exact only for commutative multiplies
            mul_parent = sr.binaryop.parent
            if (
                getattr(mul_parent, "commutes_to", None) is mul_parent
                and sr.binaryop.positional is None
            ):
                return summa_mxv_arrays(bv.T, bs.T, av, as_, sr, sr.return_type, ctx.mesh)
        if a_is_vec and b_is_vec:
            cv, cs = _dm.vxm(
                av, as_, _dm.tmap(lambda x: x[:, None], bv), bs[:, None], sr, sr.return_type,
                strategy,
            )
            return _dm.tmap(lambda x: x[0], cv), cs[0]
        if a_is_vec:
            return _dm.vxm(av, as_, bv, bs, sr, sr.return_type, strategy)
        if b_is_vec:
            return _dm.mxv(av, as_, bv, bs, sr, sr.return_type, strategy)
        return _dm.mxm(av, as_, bv, bs, sr, sr.return_type, strategy)

    return BaseExpression(
        method_name,
        out_cls,
        compute,
        op=sr,
        dtype=sr.return_type,
        shape=shape,
        args=(a, b),
        opname=f"{method_name}[{sr.name}]",
    )


def kronecker_expr(a, b, op):
    from .matrix import Matrix

    op_t = get_typed_op(op, a.dtype, b.dtype, kind="binary")
    _, opclass = find_opclass(op_t)
    if opclass == "Semiring":
        op_t = op_t.binaryop
    shape = (a.shape[0] * b.shape[0], a.shape[1] * b.shape[1])

    def compute():
        av, as_ = _arrays_of(a)
        bv, bs = _arrays_of(b)
        av = av.astype(op_t.type_.np_type)
        bv = bv.astype(op_t.type2.np_type)
        return _dm.kronecker(av, as_, bv, bs, op_t, op_t.return_type)

    return BaseExpression(
        "kronecker", Matrix, compute, op=op_t, dtype=op_t.return_type, shape=shape, args=(a, b), opname=f"kronecker[{op_t.name}]"
    )


# ---------------------------------------------------------------------------
# Assign machinery (reference: core/matrix.py:3116-3581 _prep_for_assign)
# ---------------------------------------------------------------------------


def do_assign(self, resolved, value, *, mask, accum, replace, is_submask):
    """Single sink for C(mask, accum)[idx] = value.

    Constructs Z = "C with the region replaced/merged", then applies the
    mask/replace merge:
    - GrB_assign: mask is C-shaped; replace clears anywhere outside the mask.
    - GxB_subassign (is_submask=True): mask is region-shaped; mask/replace
      effects are confined to the region.
    """
    import jax.numpy as jnp

    from .base import BaseExpression as _BE
    from .base import record_call
    from .expr import AmbiguousAssignOrExtract
    from .infix import InfixExprBase

    record_call("subassign" if is_submask else "assign", self, value)
    from .matrix import TransposedMatrix

    if isinstance(value, AmbiguousAssignOrExtract) or isinstance(value, InfixExprBase):
        value = value.new()
    elif isinstance(value, _BE):
        value = value.new()
    elif isinstance(value, TransposedMatrix):
        value = value.new()

    # -- sparse-storage assign: host pattern surgery, no densify ---------------
    # (reference: _prep_for_assign core/matrix.py:3116-3529 over hypersparse;
    # masked sparse assign falls through to the dense path, densify-guarded)
    if getattr(self, "_sparse", None) is not None and mask is None:
        if _sparse_do_assign(self, resolved, value, accum=accum):
            return

    indices = resolved.indices
    dims = [ix for ix in indices]
    region_shape = tuple(1 if ix.kind == "int" else ix.size for ix in dims)
    out_shape = resolved.out_shape  # squeezed

    # -- build region (av, as_) -------------------------------------------------
    from .matrix import Matrix
    from .vector import Vector

    deleting = False
    if self.dtype._is_udt and isinstance(value, (tuple, list, dict)):
        sc = Scalar(self.dtype)
        sc.value = value
        value = sc
    elif isinstance(value, (list, tuple, np.ndarray)):
        # dense array assignment: v[[0, 1]] = [31, 32] (reference
        # core/vector.py:1702 accepts array-likes in assign)
        arr = np.asarray(value)
        if arr.ndim == 1:
            value = Vector.from_dense(arr, dtype=self.dtype)
        elif arr.ndim == 2:
            value = Matrix.from_dense(arr, dtype=self.dtype)
        else:
            raise TypeError(f"Bad type for assignment value: {type(value)}")
    # NOTE: region structure (as_) and indices stay NUMPY: jnp ops on
    # concrete operands inside an outer gb.compile/loop trace bind to the
    # trace (jax constant lifting), which would turn the output structure
    # into a tracer and defeat compiled-loop structure hoisting
    if _is_scalar_like(value) or isinstance(value, Scalar):
        sc = _as_scalar(value)
        if sc.is_empty:
            deleting = True
            av = _dm.tmap(lambda c: jnp.zeros(region_shape, c.dtype), self._values)
            as_ = np.zeros(region_shape, bool)
        elif self.dtype._is_udt:
            dv = sc._device_value()
            av = {f: jnp.full(region_shape, dv[f]) for f in dv}
            as_ = np.ones(region_shape, bool)
        else:
            av = jnp.full(region_shape, sc._device_value(self.dtype.np_type))
            as_ = np.ones(region_shape, bool)
            if mask is not None and is_submask:
                # scalar subassign only fills where the (region) mask is true
                pass
    elif isinstance(value, Vector):
        if len(out_shape) != 1 or out_shape[0] != value.shape[0]:
            raise _exc.DimensionMismatch(
                f"shapes not compatible for assign: value {value.shape} into region {out_shape}"
            )
        if isinstance(value._values, dict):
            av = {f: a.reshape(region_shape) for f, a in value._values.items()}
        else:
            av = value._values.reshape(region_shape).astype(self._values.dtype)
        vs = value._struct
        as_ = (np.asarray(vs) if not _dm._is_tracer_arr(vs) else vs).reshape(region_shape)
    elif isinstance(value, Matrix):
        if out_shape != value.shape:
            raise _exc.DimensionMismatch(
                f"shapes not compatible for assign: value {value.shape} into region {out_shape}"
            )
        if isinstance(value._values, dict):
            av = dict(value._values)
        else:
            av = value._values.astype(self._values.dtype)
        as_ = value._struct
    else:
        raise TypeError(f"Bad type for assignment value: {type(value)}")

    # -- scatter into C-shape ----------------------------------------------------
    cv, cs = self._values, self._struct
    if self.ndim == 1:
        idx = np.atleast_1d(indices[0].index)
        start = _dm._contig_start(idx, self.shape[0])
        if start is not None:
            # slice-shaped region: dynamic_update_slice instead of an
            # n-sized scatter
            sv, ss, rsel = _dm.scatter_region_vector_contig(
                cv, cs, _dm.tmap(lambda a: a.reshape(-1), av), as_.reshape(-1), start=start
            )
        else:
            sv, ss, rsel = _dm.scatter_region_vector(
                cv, cs, idx, _dm.tmap(lambda a: a.reshape(-1), av), as_.reshape(-1)
            )
    else:
        rows = np.atleast_1d(indices[0].index)
        cols = np.atleast_1d(indices[1].index)
        rstart = _dm._contig_start(rows, self.shape[0])
        cstart = _dm._contig_start(cols, self.shape[1])
        if rstart is not None and cstart is not None:
            sv, ss, rsel = _dm.scatter_region_matrix_contig(
                cv,
                cs,
                _dm.tmap(lambda a: a.reshape(len(rows), len(cols)), av),
                as_.reshape(len(rows), len(cols)),
                rstart=rstart,
                cstart=cstart,
            )
        else:
            sv, ss, rsel = _dm.scatter_region_matrix(
                cv,
                cs,
                rows,
                cols,
                _dm.tmap(lambda a: a.reshape(len(rows), len(cols)), av),
                as_.reshape(len(rows), len(cols)),
            )

    if accum is not None and not deleting:
        # union-merge within the region instead of pattern replacement
        # (structure math via the host-side helpers — see scatter note above)
        scattered_s = _dm.s_and(rsel, ss)
        both = _dm.s_and(cs, scattered_s)
        if isinstance(cv, dict):
            acc_out = accum.fn(cv, sv)
            zv = {
                f: jnp.where(both, acc_out[f], jnp.where(scattered_s, sv[f], cv[f]))
                for f in cv
            }
        else:
            zv = jnp.where(both, accum.fn(cv, sv).astype(cv.dtype), jnp.where(scattered_s, sv, cv))
        zs = _dm.s_or(cs, scattered_s)
    else:
        zv, zs = sv, ss

    # -- mask / replace merge ----------------------------------------------------
    if mask is None:
        ncv, ncs = _dm.masked_merge(cv, cs, zv, zs, None, None, False, False)
        self._set_arrays(ncv, ncs)
        return

    mask_bits = mask._bits()
    if is_submask or mask.parent.shape != self.shape:
        # region-shaped mask: scatter its bits into C-shape
        expected = out_shape if out_shape else region_shape
        if mask.parent.shape != expected and mask.parent.shape != region_shape:
            raise _exc.DimensionMismatch(
                f"mask shape {mask.parent.shape} does not match region {out_shape} or output {self.shape}"
            )
        mb = mask_bits.reshape(region_shape)
        if self.ndim == 1:
            full_bits = jnp.zeros(self.shape, bool).at[idx].set(mb.reshape(-1))
        else:
            full_bits = (
                jnp.zeros(self.shape, bool)
                .at[rows[:, None], cols[None, :]]
                .set(mb.reshape(len(rows), len(cols)))
            )
        ncv, ncs = _dm.masked_merge(cv, cs, zv, zs, full_bits, None, bool(replace), True, region=rsel)
    else:
        ncv, ncs = _dm.masked_merge(cv, cs, zv, zs, mask_bits, None, bool(replace), True)
    self._set_arrays(ncv, ncs)


def _map_positions(pos, ix):
    """Map value positions within a region dim to parent coordinates."""
    if ix.kind == "int":
        return np.full(len(pos), ix.index, np.int64)
    if ix.kind == "all":
        return np.asarray(pos, np.int64)
    return np.atleast_1d(np.asarray(ix.index, np.int64))[np.asarray(pos, np.int64)]


def _sparse_do_assign(self, resolved, value, *, accum):
    """Assign into sparse storage.  Returns True when handled; False falls
    back to the (densify-guarded) dense path."""
    from .matrix import Matrix
    from .sparse import (
        _SCALAR_FILL_LIMIT,
        sparse_assign,
        sparse_delete_region,
        sparse_vec_assign,
        sparse_vec_delete_region,
    )
    from .vector import Vector

    indices = resolved.indices
    np_dtype = np.dtype(self.dtype.np_type)
    sp = self._sparse

    def region_cells():
        cells = 1
        for ix in indices:
            cells *= 1 if ix.kind == "int" else ix.size
        return cells

    if _is_scalar_like(value) or isinstance(value, Scalar):
        sc = _as_scalar(value)
        if sc.is_empty:
            if self.ndim == 1:
                self._adopt_sparse(sparse_vec_delete_region(sp, indices[0]))
            else:
                self._adopt_sparse(sparse_delete_region(sp, indices))
            return True
        cells = region_cells()
        if cells > _SCALAR_FILL_LIMIT:
            raise _exc.OutOfMemory(
                f"scalar assign would create {cells} entries "
                f"(> {_SCALAR_FILL_LIMIT}); iso-valued regions of that size are "
                "not supported on sparse storage"
            )
        val = np.asarray(sc.value, np_dtype)
        if self.ndim == 1:
            ix = indices[0]
            tgt = (
                np.asarray([ix.index], np.int64)
                if ix.kind == "int"
                else _map_positions(np.arange(ix.size), ix)
            )
            new_v = np.full(len(tgt), val, np_dtype)
            self._adopt_sparse(sparse_vec_assign(sp, ix, tgt, new_v, accum, np_dtype))
            return True
        rix, cix = indices
        tr = (
            np.asarray([rix.index], np.int64)
            if rix.kind == "int"
            else _map_positions(np.arange(rix.size), rix)
        )
        tc = (
            np.asarray([cix.index], np.int64)
            if cix.kind == "int"
            else _map_positions(np.arange(cix.size), cix)
        )
        rr = np.repeat(tr, len(tc))
        cc = np.tile(tc, len(tr))
        new_v = np.full(len(rr), val, np_dtype)
        self._adopt_sparse(sparse_assign(sp, indices, rr, cc, new_v, accum, np_dtype))
        return True

    if isinstance(value, (list, tuple, np.ndarray)):
        arr = np.asarray(value)
        if arr.ndim == 1:
            value = Vector.from_dense(arr, dtype=self.dtype)
        elif arr.ndim == 2:
            value = Matrix.from_dense(arr, dtype=self.dtype)

    if self.ndim == 1:
        if not isinstance(value, Vector):
            return False
        ix = indices[0]
        expected = 1 if ix.kind == "int" else ix.size
        if value.size != expected:
            raise _exc.DimensionMismatch(
                f"shapes not compatible for assign: value {value.shape} into region ({expected},)"
            )
        vi, vv = value.to_coo()
        tgt = _map_positions(vi.astype(np.int64), ix)
        self._adopt_sparse(
            sparse_vec_assign(sp, ix, tgt, np.asarray(vv), accum, np_dtype)
        )
        return True

    rix, cix = indices
    if isinstance(value, Vector):
        vi, vv = value.to_coo()
        vi = vi.astype(np.int64)
        if rix.kind == "int":
            expected = cix.size
            if value.size != expected:
                raise _exc.DimensionMismatch(
                    f"shapes not compatible for assign: value {value.shape} into region ({expected},)"
                )
            rr = np.full(len(vi), rix.index, np.int64)
            cc = _map_positions(vi, cix)
        elif cix.kind == "int":
            expected = rix.size
            if value.size != expected:
                raise _exc.DimensionMismatch(
                    f"shapes not compatible for assign: value {value.shape} into region ({expected},)"
                )
            rr = _map_positions(vi, rix)
            cc = np.full(len(vi), cix.index, np.int64)
        else:
            return False  # broadcast vector assign: dense path
        self._adopt_sparse(
            sparse_assign(sp, indices, rr, cc, np.asarray(vv), accum, np_dtype)
        )
        return True
    if isinstance(value, Matrix):
        expected = (
            1 if rix.kind == "int" else rix.size,
            1 if cix.kind == "int" else cix.size,
        )
        if value.shape != expected:
            raise _exc.DimensionMismatch(
                f"shapes not compatible for assign: value {value.shape} into region {expected}"
            )
        vr, vc, vv = value.to_coo()
        rr = _map_positions(vr.astype(np.int64), rix)
        cc = _map_positions(vc.astype(np.int64), cix)
        self._adopt_sparse(
            sparse_assign(sp, indices, rr, cc, np.asarray(vv), accum, np_dtype)
        )
        return True
    return False


def do_delete(self, resolved, mask=None):
    """del C[idx] — remove entries in the region (reference: __delitem__)."""
    import jax.numpy as jnp

    from .base import record_call

    if mask is not None:
        # Masked delete == masked assign of an empty scalar (the reference's
        # recipe): only masked positions within the region are cleared.
        # (records itself as "assign")
        empty = Scalar(self.dtype)
        return do_assign(
            self, resolved, empty, mask=mask, accum=None, replace=False, is_submask=False
        )
    record_call("delete", self)
    indices = resolved.indices
    if getattr(self, "_sparse", None) is not None:
        from .sparse import sparse_delete_region, sparse_vec_delete_region

        if self.ndim == 1:
            self._adopt_sparse(sparse_vec_delete_region(self._sparse, indices[0]))
        else:
            self._adopt_sparse(sparse_delete_region(self._sparse, indices))
        return
    cv, cs = self._values, self._struct
    if self.ndim == 1:
        idx = jnp.asarray(np.atleast_1d(indices[0].index))
        cs = cs.at[idx].set(False)
        cv = _dm.tmap(lambda a: a.at[idx].set(0), cv)
    else:
        rows = jnp.asarray(np.atleast_1d(indices[0].index))
        cols = jnp.asarray(np.atleast_1d(indices[1].index))
        cs = cs.at[rows[:, None], cols[None, :]].set(False)
        cv = _dm.tmap(lambda a: a.at[rows[:, None], cols[None, :]].set(0), cv)
    self._set_arrays(cv, cs)
