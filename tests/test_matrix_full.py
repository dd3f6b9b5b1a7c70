"""Matrix behavioral suite at reference granularity (one test per behavior,
mirroring the coverage checklist of reference graphblas/tests/test_matrix.py —
independently implemented against GraphBLAS semantics + the dict oracle)."""

import os as _os
import pickle

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import Matrix, Scalar, Vector, agg, binary, dtypes, indexunary, monoid, semiring, unary
from graphblas_tpu.exceptions import (
    DimensionMismatch,
    IndexOutOfBound,
    OutputNotEmpty,
)

import oracle as orc

R = [3, 0, 3, 5, 6, 0, 6, 1, 6, 2, 4, 1]
C = [0, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6]
V = [3, 2, 3, 1, 5, 3, 7, 8, 3, 1, 7, 4]


@pytest.fixture
def A():
    return Matrix.from_coo(R, C, V, dtypes.INT64, nrows=7, ncols=7)


@pytest.fixture
def v():
    return Vector.from_coo([1, 3, 4, 6], [1, 1, 2, 0], dtypes.INT64, size=7)


def test_new():
    B = Matrix(dtypes.FP32, 3, 4)
    assert B.dtype == dtypes.FP32
    assert B.nrows == 3 and B.ncols == 4
    assert B.nvals == 0
    assert B.shape == (3, 4)


def test_dup(A):
    B = A.dup()
    assert B.isequal(A)
    A[0, 0] = 100
    assert B[0, 0].new().is_empty
    B2 = A.dup(dtypes.FP64)
    assert B2.dtype == dtypes.FP64
    assert B2.isclose(A)


def test_dup_clear(A):
    B = A.dup(clear=True)
    assert B.nvals == 0 and B.shape == A.shape and B.dtype == A.dtype


def test_dup_mask(A):
    m = Matrix.from_coo([3, 0], [0, 1], True, nrows=7, ncols=7)
    B = A.dup(mask=m.S)
    assert orc.to_dict(B) == {(3, 0): 3, (0, 1): 2}


def test_from_coo_scalar():
    B = Matrix.from_coo([0, 1], [1, 2], 9, nrows=3, ncols=3)
    assert orc.to_dict(B) == {(0, 1): 9, (1, 2): 9}


def test_from_coo_dup_op():
    B = Matrix.from_coo([0, 0, 1], [1, 1, 0], [1, 2, 5], nrows=2, ncols=2, dup_op=binary.plus)
    assert orc.to_dict(B) == {(0, 1): 3, (1, 0): 5}
    with pytest.raises(ValueError):
        Matrix.from_coo([], [], [])


def test_clear(A):
    A.clear()
    assert A.nvals == 0
    assert A.shape == (7, 7)


def test_resize(A):
    d = orc.to_dict(A)
    A.resize(10, 12)
    assert A.shape == (10, 12)
    assert orc.to_dict(A) == d
    A.resize(4, 4)
    assert orc.to_dict(A) == {k: x for k, x in d.items() if k[0] < 4 and k[1] < 4}


def test_nrows_ncols_nvals(A):
    assert A.nrows == 7
    assert A.ncols == 7
    assert A.nvals == 12


def test_build(A):
    B = Matrix(dtypes.INT64, 3, 3)
    B.build([0, 2], [1, 2], [5, 6])
    assert orc.to_dict(B) == {(0, 1): 5, (2, 2): 6}
    with pytest.raises(OutputNotEmpty):
        B.build([0], [0], [1])
    B.build([1], [1], [9], clear=True)
    assert orc.to_dict(B) == {(1, 1): 9}


def test_extract_element(A):
    assert A[3, 0].new().value == 3
    assert A[0, 0].new().is_empty
    assert A[-1, -4].new().value == 7
    s = A[1, 4].new(dtype=dtypes.FP32)
    assert s.value == 8.0


def test_set_element(A):
    A[0, 0] = 17
    A[-1, -1] = -3
    assert A[0, 0].new().value == 17
    assert A[6, 6].new().value == -3


def test_remove_element(A):
    del A[3, 0]
    assert A[3, 0].new().is_empty
    del A[-1, -5]
    assert A[6, 2].new().is_empty
    assert A.nvals == 10


def test_mxm(A):
    got = A.mxm(A, semiring.plus_times).new()
    da = orc.to_dict(A)
    expected = orc.mxm(da, da, lambda a, b: a + b, orc.simple_mul(lambda x, y: x * y))
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_mxm_transpose(A):
    da = orc.to_dict(A)
    dat = {(j, i): x for (i, j), x in da.items()}
    got = A.T.mxm(A, semiring.plus_times).new()
    expected = orc.mxm(dat, da, lambda a, b: a + b, orc.simple_mul(lambda x, y: x * y))
    orc.assert_equal_dicts(orc.to_dict(got), expected)
    got = A.mxm(A.T, semiring.plus_times).new()
    expected = orc.mxm(da, dat, lambda a, b: a + b, orc.simple_mul(lambda x, y: x * y))
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_mxm_nonsquare():
    A2 = Matrix.from_coo([0, 0], [1, 2], [2, 3], nrows=1, ncols=3)
    B2 = Matrix.from_coo([1, 2], [0, 0], [4, 5], nrows=3, ncols=1)
    got = A2.mxm(B2, semiring.plus_times).new()
    assert got.shape == (1, 1)
    assert got[0, 0].new().value == 2 * 4 + 3 * 5
    with pytest.raises(DimensionMismatch):
        A2.mxm(A2, semiring.plus_times).new()


def test_mxm_mask(A):
    m = Matrix.from_coo([0, 3, 4], [1, 2, 5], True, nrows=7, ncols=7)
    out = A.dup()
    out(m.S, replace=True) << A.mxm(A, semiring.plus_times)
    full = orc.to_dict(A.mxm(A, semiring.plus_times).new())
    expected = {k: x for k, x in full.items() if k in {(0, 1), (3, 2), (4, 5)}}
    orc.assert_equal_dicts(orc.to_dict(out), expected)


def test_mxm_accum(A):
    d0 = orc.to_dict(A)
    prod = orc.to_dict(A.mxm(A, semiring.plus_times).new())
    A(accum=binary.plus) << A.mxm(A, semiring.plus_times)
    expected = dict(prod)
    for k, x in d0.items():
        expected[k] = expected.get(k, 0) + x
    orc.assert_equal_dicts(orc.to_dict(A), expected)


def test_mxv(A, v):
    got = A.mxv(v, semiring.plus_times).new()
    da, dv = orc.to_dict(A), orc.to_dict(v)
    expected = {}
    for (i, j), x in da.items():
        if j in dv:
            expected[i] = expected.get(i, 0) + x * dv[j]
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_ewise_mult(A):
    B = A.T.new()
    got = A.ewise_mult(B, binary.times).new()
    expected = orc.ewise_mult(orc.to_dict(A), orc.to_dict(B), lambda a, b: a * b)
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_ewise_add(A):
    B = A.T.new()
    got = A.ewise_add(B, binary.plus).new()
    expected = orc.ewise_add(orc.to_dict(A), orc.to_dict(B), lambda a, b: a + b)
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_extract_submatrix(A):
    got = A[[0, 3, 6], [1, 2, 4]].new()
    da = orc.to_dict(A)
    rmap = {0: 0, 3: 1, 6: 2}
    cmap = {1: 0, 2: 1, 4: 2}
    expected = {
        (rmap[i], cmap[j]): x for (i, j), x in da.items() if i in rmap and j in cmap
    }
    orc.assert_equal_dicts(orc.to_dict(got), expected)
    got2 = A[1:4, :].new()
    expected2 = {(i - 1, j): x for (i, j), x in da.items() if 1 <= i < 4}
    orc.assert_equal_dicts(orc.to_dict(got2), expected2)


def test_extract_row(A):
    got = A[6, :].new()
    da = orc.to_dict(A)
    orc.assert_equal_dicts(orc.to_dict(got), {j: x for (i, j), x in da.items() if i == 6})
    got2 = A[6, [2, 3]].new()
    assert orc.to_dict(got2) == {0: 5, 1: 7}


def test_extract_column(A):
    got = A[:, 2].new()
    da = orc.to_dict(A)
    orc.assert_equal_dicts(orc.to_dict(got), {i: x for (i, j), x in da.items() if j == 2})
    got2 = A[[3, 5], 2].new()
    assert orc.to_dict(got2) == {0: 3, 1: 1}


def test_extract_input_mask(A):
    m = Matrix.from_coo([3, 5], [0, 2], True, nrows=7, ncols=7)
    got = A[[3, 5], [0, 2]].new(input_mask=m.S)
    assert orc.to_dict(got) == {(0, 0): 3, (1, 1): 1}


def test_assign_matrix(A):
    B = Matrix.from_coo([0, 1], [0, 1], [91, 92], nrows=2, ncols=2)
    A[[0, 1], [0, 1]] = B
    d = orc.to_dict(A)
    assert d[(0, 0)] == 91 and d[(1, 1)] == 92
    assert (0, 1) not in d  # region cleared where B is empty


def test_assign_wrong_dims(A):
    B = Matrix.from_coo([0], [0], [1], nrows=2, ncols=3)
    with pytest.raises(DimensionMismatch):
        A[[0, 1], [0, 1]] = B


def test_assign_row(A, v):
    A[2, :] = v
    da = orc.to_dict(A)
    for k, x in orc.to_dict(v).items():
        assert da[(2, k)] == x
    assert (2, 5) not in da


def test_assign_column(A, v):
    A[:, 0] = v
    da = orc.to_dict(A)
    for k, x in orc.to_dict(v).items():
        assert da[(k, 0)] == x
    assert (0, 0) not in da  # column slots where v is empty are cleared


def test_assign_row_scalar(A):
    A[2, :] = 9
    da = orc.to_dict(A)
    assert all(da[(2, j)] == 9 for j in range(7))


def test_assign_column_scalar(A):
    A[:, 6] = -1
    da = orc.to_dict(A)
    assert all(da[(i, 6)] == -1 for i in range(7))


def test_assign_scalar_region(A):
    A[[0, 1], [0, 1]] = 7
    da = orc.to_dict(A)
    assert da[(0, 0)] == da[(0, 1)] == da[(1, 0)] == da[(1, 1)] == 7


def test_subassign_row_col(A):
    m = Vector.from_coo([0, 2], True, size=3)
    A[3, [0, 1, 2]](m.S) << Vector.from_coo([0, 1, 2], [70, 71, 72], size=3)
    da = orc.to_dict(A)
    assert da[(3, 0)] == 70 and da[(3, 2)] == 72
    assert (3, 1) not in da or da[(3, 1)] != 71


def test_subassign_matrix(A):
    sub = Matrix.from_coo([0, 1], [1, 0], [55, 66], nrows=2, ncols=2)
    m = Matrix.from_coo([0], [1], True, nrows=2, ncols=2)
    A[[0, 1], [0, 1]](m.S) << sub
    da = orc.to_dict(A)
    assert da[(0, 1)] == 55
    assert (1, 0) not in da or da[(1, 0)] != 66


def test_assign_row_col_matrix_mask(A):
    """Row assign with a vector mask (GrB_Row_assign semantics)."""
    m = Vector.from_coo([1, 3], True, size=7)
    w = Vector.from_scalar(42, 7, dtypes.INT64)
    A(m.S)[4, :] = w
    da = orc.to_dict(A)
    assert da[(4, 1)] == 42 and da[(4, 3)] == 42
    assert (4, 0) not in da


def test_assign_transpose(A):
    B = Matrix(dtypes.INT64, 7, 7)
    B[:, :] = A.T
    assert B.isequal(A.T.new())


def test_assign_list(A):
    A[[0, 1], [0, 1]] = [[1, 2], [3, 4]]
    da = orc.to_dict(A)
    assert da[(0, 0)] == 1 and da[(1, 1)] == 4


def test_apply(A):
    got = A.apply(unary.ainv).new()
    orc.assert_equal_dicts(orc.to_dict(got), {k: -x for k, x in orc.to_dict(A).items()})


def test_apply_binary(A):
    got = A.apply(binary.times, right=2).new()
    orc.assert_equal_dicts(orc.to_dict(got), {k: 2 * x for k, x in orc.to_dict(A).items()})
    got = A.apply(binary.minus, left=100).new()
    orc.assert_equal_dicts(orc.to_dict(got), {k: 100 - x for k, x in orc.to_dict(A).items()})


def test_apply_indexunary(A):
    got = A.apply(indexunary.rowindex).new()
    orc.assert_equal_dicts(orc.to_dict(got), {k: k[0] for k in orc.to_dict(A)})
    got = A.apply(indexunary.colindex).new()
    orc.assert_equal_dicts(orc.to_dict(got), {k: k[1] for k in orc.to_dict(A)})


def test_select(A):
    got = A.select("tril").new()
    orc.assert_equal_dicts(
        orc.to_dict(got), {k: x for k, x in orc.to_dict(A).items() if k[0] >= k[1]}
    )
    got = A.select("triu", 1).new()
    orc.assert_equal_dicts(
        orc.to_dict(got), {k: x for k, x in orc.to_dict(A).items() if k[1] - k[0] >= 1}
    )
    got = A.select(">=", 5).new()
    orc.assert_equal_dicts(
        orc.to_dict(got), {k: x for k, x in orc.to_dict(A).items() if x >= 5}
    )


def test_select_bools_and_masks(A):
    m = Matrix.from_coo([3, 0], [0, 1], True, nrows=7, ncols=7)
    got = A.select(m.S).new()
    assert orc.to_dict(got) == {(3, 0): 3, (0, 1): 2}
    got2 = A.select(A.apply(binary.gt, right=4)).new()
    orc.assert_equal_dicts(
        orc.to_dict(got2), {k: x for k, x in orc.to_dict(A).items() if x > 4}
    )


def test_indexunary_udf(A):
    def iplusj(x, i, j, thunk):
        return i + j

    op = gb.indexunary.register_anonymous(iplusj)
    got = A.apply(op, 0).new()
    orc.assert_equal_dicts(orc.to_dict(got), {k: k[0] + k[1] for k in orc.to_dict(A)})


def test_reduce_row(A):
    got = A.reduce_rowwise(monoid.plus).new()
    da = orc.to_dict(A)
    expected = {}
    for (i, _), x in da.items():
        expected[i] = expected.get(i, 0) + x
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_reduce_column(A):
    got = A.reduce_columnwise(monoid.max).new()
    da = orc.to_dict(A)
    expected = {}
    for (_, j), x in da.items():
        expected[j] = max(expected.get(j, -(10**18)), x)
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_reduce_scalar(A):
    assert A.reduce_scalar(monoid.plus).new().value == sum(V)
    assert A.reduce_scalar(monoid.min).new().value == min(V)
    e = Matrix(dtypes.INT64, 2, 2)
    assert e.reduce_scalar(monoid.plus).new().is_empty
    assert e.reduce_scalar(monoid.plus, allow_empty=False).new().value == 0


def test_reduce_agg(A):
    assert A.reduce_scalar(agg.count).new().value == 12
    assert A.reduce_scalar(agg.mean).new().value == pytest.approx(np.mean(V))
    got = A.reduce_rowwise(agg.count).new()
    da = orc.to_dict(A)
    expected = {}
    for (i, _), _x in da.items():
        expected[i] = expected.get(i, 0) + 1
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_reduce_agg_argminmax(A):
    got = A.reduce_rowwise(agg.argmax).new()
    da = orc.to_dict(A)
    for i, j in orc.to_dict(got).items():
        row = {jj: x for (ii, jj), x in da.items() if ii == i}
        assert row[j] == max(row.values())
    got = A.reduce_columnwise(agg.argmin).new()
    for j, i in orc.to_dict(got).items():
        col = {ii: x for (ii, jj), x in da.items() if jj == j}
        assert col[i] == min(col.values())


def test_transpose(A):
    T = A.T.new()
    orc.assert_equal_dicts(
        orc.to_dict(T), {(j, i): x for (i, j), x in orc.to_dict(A).items()}
    )
    assert A.T.T is A  # double transpose returns the original


def test_transpose_equals(A):
    sym = A.ewise_add(A.T, binary.plus).new()
    assert sym.isequal(sym.T.new())


def test_kronecker():
    A2 = Matrix.from_coo([0, 1], [1, 0], [2, 3], nrows=2, ncols=2)
    B2 = Matrix.from_coo([0], [0], [5], nrows=2, ncols=2)
    got = A2.kronecker(B2, binary.times).new()
    assert got.shape == (4, 4)
    assert orc.to_dict(got) == {(0, 2): 10, (2, 0): 15}


def test_simple_assignment(A):
    B = Matrix(dtypes.INT64, 7, 7)
    B << A
    assert B.isequal(A)


def test_isequal(A):
    assert A.isequal(A.dup())
    B = A.dup()
    B[0, 0] = 1
    assert not A.isequal(B)
    assert not A.isequal(Matrix(dtypes.INT64, 7, 6))


def test_isclose():
    A1 = Matrix.from_coo([0], [0], [1.0], nrows=2, ncols=2)
    A2 = Matrix.from_coo([0], [0], [1.0 + 1e-9], nrows=2, ncols=2)
    assert A1.isclose(A2)
    assert not A1.isclose(A2, rel_tol=1e-12)


def test_nested_matrix_operations(A):
    got = A.mxm(A.ewise_mult(A, binary.plus), semiring.plus_times).new()
    doubled = {k: 2 * x for k, x in orc.to_dict(A).items()}
    expected = orc.mxm(
        orc.to_dict(A), doubled, lambda a, b: a + b, orc.simple_mul(lambda x, y: x * y)
    )
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_bad_init():
    with pytest.raises(Exception):
        Matrix(dtypes.INT64, -1, 4)


def test_bad_update(A):
    with pytest.raises((TypeError, AttributeError)):
        A << object()


def test_incompatible_shapes(A):
    B = Matrix(dtypes.INT64, 6, 6)
    with pytest.raises(DimensionMismatch):
        A.ewise_add(B, binary.plus).new()
    with pytest.raises(DimensionMismatch):
        A.mxm(B, semiring.plus_times).new()


def test_del_region(A):
    del A[0:4, :]
    da = orc.to_dict(A)
    assert all(i >= 4 for (i, _j) in da)


def test_contains(A):
    assert (3, 0) in A
    assert (0, 0) not in A
    assert (-1, -4) in A


def test_iter(A):
    items = list(A)
    assert len(items) == 12
    assert all(len(t) == 2 for t in items)


def test_wait(A):
    A.wait()
    A.wait("complete")


def test_pickle_roundtrip(A):
    B = pickle.loads(pickle.dumps(A))
    assert B.isequal(A, check_dtype=True)


def test_weakref(A):
    import weakref

    assert weakref.ref(A)() is A


def test_not_to_array(A):
    with pytest.raises(TypeError):
        np.array(A)


def test_diag_extract(A):
    d = A.diag()
    da = orc.to_dict(A)
    orc.assert_equal_dicts(orc.to_dict(d), {i: x for (i, j), x in da.items() if i == j})
    d1 = A.diag(-1)
    orc.assert_equal_dicts(orc.to_dict(d1), {j: x for (i, j), x in da.items() if i == j + 1})


def test_setdiag(A):
    A.setdiag(0)
    da = orc.to_dict(A)
    assert all(da[(i, i)] == 0 for i in range(7))


def test_setdiag_mask(A):
    m = Vector.from_coo([0, 2], True, size=7)
    B = A.dup()
    B.setdiag(99, mask=m.S)
    db = orc.to_dict(B)
    assert db[(0, 0)] == 99 and db[(2, 2)] == 99
    assert (1, 1) not in db


def test_split(A):
    parts = A.tx.split([4, [3, 4]])
    assert parts[0][0].shape == (4, 3)
    assert parts[1][1].shape == (3, 4)
    da = orc.to_dict(A)
    orc.assert_equal_dicts(
        orc.to_dict(parts[0][0]), {k: x for k, x in da.items() if k[0] < 4 and k[1] < 3}
    )


def test_concat(A):
    halves = A.tx.split([None, [3, 4]])
    back = gb.tx.concat([[halves[0][0], halves[0][1]]])
    assert back.isequal(A)


def test_flatten_reshape(A):
    f = A.tx.flatten()
    assert f.size == 49
    da = orc.to_dict(A)
    orc.assert_equal_dicts(orc.to_dict(f), {i * 7 + j: x for (i, j), x in da.items()})
    back = f.tx.reshape(7, 7)
    assert back.isequal(A)


def test_auto(A):
    expr = A.ewise_mult(A, binary.plus)
    assert expr.nvals == A.nvals
    assert expr.nrows == 7


def test_expr_is_like_matrix(A):
    expr = A.apply(unary.one)
    got = expr.reduce_scalar(monoid.plus).new()
    assert got.value == A.nvals


def test_index_expr_is_like_matrix(A):
    expr = A[0:3, :]
    assert expr.nrows == 3
    got = expr.select(">", 2).new()
    da = orc.to_dict(A)
    expected = {(i, j): x for (i, j), x in da.items() if i < 3 and x > 2}
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_dup_expr(A):
    expr = A.ewise_add(A.T, binary.plus)
    B = expr.dup()
    assert B.isequal(expr.new())


def test_infix_sugar(A):
    got = (A @ A).new()
    ref = A.mxm(A, semiring.plus_times).new()
    assert got.isequal(ref)
    got = (A + A).new()
    orc.assert_equal_dicts(orc.to_dict(got), {k: 2 * x for k, x in orc.to_dict(A).items()})


def test_ndim_sizeof(A):
    import sys

    assert A.ndim == 2
    assert sys.getsizeof(A) > 0


def test_ewise_union(A):
    B = A.T.new()
    got = A.ewise_union(B, binary.minus, 0, 0).new()
    expected = orc.ewise_union(orc.to_dict(A), orc.to_dict(B), lambda a, b: a - b, 0, 0)
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_delete_via_scalar(A):
    A[3, [0, 2]] = Scalar(dtypes.INT64)
    da = orc.to_dict(A)
    assert (3, 0) not in da and (3, 2) not in da


def test_reposition(A):
    got = A.reposition(1, 2).new()
    da = orc.to_dict(A)
    expected = {
        (i + 1, j + 2): x for (i, j), x in da.items() if i + 1 < 7 and j + 2 < 7
    }
    orc.assert_equal_dicts(orc.to_dict(got), expected)


def test_to_coo_sort(A):
    r, c, _ = A.to_coo(sort=True)
    keys = list(zip(r.tolist(), c.tolist()))
    assert keys == sorted(keys)


def test_to_coo_subset(A):
    r, _, _ = A.to_coo(columns=False, values=False)
    assert r is not None
    _, c, x = A.to_coo(rows=False)
    assert len(c) == len(x) == 12


def test_get(A):
    assert A.get(3, 0) == 3
    assert A.get(0, 0) is None
    assert A.get(0, 0, default=-1) == -1


def test_to_csr_from_csc(A):
    indptr, col_indices, values = A.to_csr()
    B = Matrix.from_csr(indptr, col_indices, values, ncols=7)
    assert B.isequal(A)
    cptr, row_indices, cvalues = A.to_csc()
    C2 = Matrix.from_csc(cptr, row_indices, cvalues, nrows=7)
    assert C2.isequal(A)


def test_to_dcsr_from_dcsc(A):
    rows, indptr, cols, vals = A.to_dcsr()
    B = Matrix.from_dcsr(rows, indptr, cols, vals, nrows=7, ncols=7)
    assert B.isequal(A)
    cols2, cptr, rows2, vals2 = A.to_dcsc()
    C2 = Matrix.from_dcsc(cols2, cptr, rows2, vals2, nrows=7, ncols=7)
    assert C2.isequal(A)


def test_as_vector():
    col = Matrix.from_coo([0, 2], [0, 0], [5, 6], nrows=3, ncols=1)
    w = col._as_vector()
    assert orc.to_dict(w) == {0: 5, 2: 6}


def test_to_dicts_from_dicts(A):
    d = A.to_dicts()
    B = Matrix.from_dicts(d, nrows=7, ncols=7)
    assert B.isequal(A)
    dc = A.to_dicts("columnwise")
    C2 = Matrix.from_dicts(dc, order="columnwise", nrows=7, ncols=7)
    assert C2.isequal(A)


def test_from_list_of_dicts():
    B = Matrix.from_dicts([{0: 1}, {}, {2: 5}], ncols=3)
    assert orc.to_dict(B) == {(0, 0): 1, (2, 2): 5}


def test_to_from_edgelist(A):
    edges, values = A.to_edgelist()
    B = Matrix.from_edgelist(edges, values, nrows=7, ncols=7)
    assert B.isequal(A)


def test_from_scalar():
    B = Matrix.from_scalar(3, 2, 2)
    assert B.nvals == 4
    assert orc.to_dict(B) == {(0, 0): 3, (0, 1): 3, (1, 0): 3, (1, 1): 3}


def test_to_dense_from_dense(A):
    arr = A.to_dense(fill_value=0)
    assert arr.shape == (7, 7)
    B = Matrix.from_dense(arr, missing_value=0)
    assert B.isequal(A)


def test_tx_sort(A):
    S, P = A.tx.sort(binary.lt)
    da = orc.to_dict(A)
    for i in range(7):
        row = sorted(x for (ii, _), x in da.items() if ii == i)
        got_row = [x for (ii, _), x in sorted(orc.to_dict(S).items()) if ii == i]
        assert got_row == row


def test_power(A):
    got = A.power(2, semiring.plus_times).new()
    ref = A.mxm(A, semiring.plus_times).new()
    assert got.isequal(ref)
    got3 = A.power(3, semiring.plus_times).new()
    ref3 = ref.mxm(A, semiring.plus_times).new()
    assert got3.isequal(ref3)
    eye = A.power(0).new()  # n=0: diagonal of the op identity (reference 2851)
    assert eye[2, 2].new().value == 1 and eye[0, 1].new().is_empty
    with pytest.raises(ValueError):
        A.power(-1)


def test_bool_as_mask(A):
    m = A.apply(binary.gt, right=3).new()
    out = Matrix(dtypes.INT64, 7, 7)
    out(m) << A  # bool matrix auto-lifts to ValueMask
    expected = {k: x for k, x in orc.to_dict(A).items() if x > 3}
    orc.assert_equal_dicts(orc.to_dict(out), expected)


def test_reduce_row_udf(A):
    bop = gb.binary.register_anonymous(lambda x, y: x + 2 * y)
    mon = gb.monoid.register_anonymous(gb.binary.register_anonymous(lambda x, y: x + y), 0)
    got = A.reduce_rowwise(mon).new()
    da = orc.to_dict(A)
    expected = {}
    for (i, _), x in da.items():
        expected[i] = expected.get(i, 0) + x
    orc.assert_equal_dicts(orc.to_dict(got), expected)
    assert bop is not None


def test_matrix_udt_roundtrip():
    udt = dtypes.register_anonymous([("x", np.int32), ("y", np.float32)])
    B = Matrix(udt, 2, 2)
    B[0, 1] = (3, 1.5)
    val = B[0, 1].new().value
    assert val["x"] == 3 and val["y"] == 1.5


def test_mxm_empty_result(A):
    empty = Matrix(dtypes.INT64, 7, 7)
    got = A.mxm(empty, semiring.plus_times).new()
    assert got.nvals == 0


def test_transpose_exceptional(A):
    with pytest.raises((AttributeError, TypeError)):
        A.T[0, 0] = 5


def test_assign_bad(A):
    with pytest.raises((TypeError, ValueError)):
        A[0, 0] = object()


def test_transposed_view_zero_copy_delegations():
    """Exports/reductions on A.T swap roles on the parent instead of
    materializing a transposed copy (reference keeps the view compute-free,
    core/matrix.py:3825-3920)."""
    A = Matrix.from_coo([0, 1, 2, 0], [1, 2, 0, 2], [1.0, 2.0, 3.0, 4.0], dtypes.FP32, nrows=3, ncols=4)
    T = A.T
    r, c, v = T.to_coo()
    assert list(zip(r.tolist(), c.tolist())) == sorted(zip(r.tolist(), c.tolist()))
    dense = np.zeros((4, 3))
    ar, ac, av = A.to_coo()
    dense[ac, ar] = av
    np.testing.assert_array_equal(dense[r, c], v)
    ip, ci, _ = T.to_csr()
    ip2, ri2, _ = A.to_csc()
    np.testing.assert_array_equal(ip, ip2)
    np.testing.assert_array_equal(ci, ri2)
    np.testing.assert_array_equal(T.to_dense(0.0), A.to_dense(0.0).T)
    assert T.to_dicts() == A.to_dicts("columnwise")
    assert T.get(1, 0) == 1.0 and (1, 0) in T and (0, 1) not in T
    np.testing.assert_array_equal(
        np.asarray(T.reduce_rowwise("plus").new().to_dense(0.0)),
        np.asarray(A.reduce_columnwise("plus").new().to_dense(0.0)),
    )
    assert float(T.reduce_scalar("plus").new().value) == 10.0
    B = Matrix.from_coo([0, 1], [1, 2], [5.0, 6.0], dtypes.FP32, nrows=3, ncols=3)
    np.testing.assert_array_equal(
        np.asarray(B.T.diag(-1).to_dense(0.0)), np.asarray(B.diag(1).to_dense(0.0))
    )
    edges, _ = T.to_edgelist()
    np.testing.assert_array_equal(edges[:, 0], r)


def test_reduce_string_default_without_monoid_import():
    """reduce with the default/string op resolves the monoid back-link even
    when graphblas_tpu.monoid was never imported (lazy-init ordering)."""
    import subprocess
    import sys as _sys

    code = (
        "import sys; sys.path.insert(0, %r); "
        "from graphblas_tpu import Matrix, dtypes; "
        "A = Matrix.from_coo([0,1],[1,2],[1.,2.], dtypes.FP32, nrows=3, ncols=3); "
        "r, v = A.reduce_columnwise().new().to_coo(); "
        "assert v.tolist() == [1.0, 2.0], v"
    ) % _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    env = dict(_os.environ)
    env.update(JAX_PLATFORMS="cpu", GRAPHBLAS_TPU_PLATFORM="cpu")
    proc = subprocess.run([_sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_reference_edge_behaviors_matrix():
    """Matrix-side reference contracts: np.array refusal, Scalar indices,
    expression attribute/T delegation, delete-via-empty-scalar, sizeof."""
    import sys as _sys

    A = Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], dtypes.FP64, nrows=2, ncols=2)
    with pytest.raises(TypeError):
        np.array(A)
    assert A[Scalar.from_value(0), Scalar.from_value(1)].new().value == 1.0
    expr = A.apply(unary.ainv)
    assert expr.nrows == 2 and expr.ncols == 2
    assert A.mxm(A).T.new().shape == (2, 2)
    C = A.dup()
    C[0, 1] = Scalar(dtypes.FP64)  # empty-scalar assign deletes
    assert C.nvals == 1 and C.get(0, 1) is None
    assert _sys.getsizeof(A) > 0
