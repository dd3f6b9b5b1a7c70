"""gb.compile / gb.loop / gb.until — DSL loop capture.

The reference's perf contract is 1 statement = 1 fused C call
(reference: docs/user_guide/fundamentals.rst:118-120); the analogue here is
1 loop of DSL statements = 1 jitted XLA program.  These tests assert the
captured loops compute exactly what the eager DSL computes, that structure
hoisting engages for structurally-stable loops, and that data-dependent
structure (BFS frontiers) transparently falls back to carried structure.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import binary, monoid, semiring
from graphblas_tpu.core import dtypes as dtm
from graphblas_tpu.core.compiler import last_loop_mode
from graphblas_tpu.core.matrix import Matrix
from graphblas_tpu.core.scalar import Scalar
from graphblas_tpu.core.vector import Vector
from graphblas_tpu.models import dsl


def _rand_graph(n=120, e=700, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    pair = src.astype(np.int64) * n + dst
    _, uidx = np.unique(pair, return_index=True)
    src, dst = src[uidx], dst[uidx]
    w = (rng.random(len(src)) + 0.1).astype(np.float32) if weighted else None
    return src, dst, w


# ---------------------------------------------------------------------------
# gb.loop basics
# ---------------------------------------------------------------------------


def test_loop_vector_values_only():
    v = Vector.from_dense(np.arange(8, dtype=np.float64))

    def body(x):
        return x.apply(binary.plus, right=1.0).new(x.dtype)

    out = gb.loop(5, body, v)
    assert isinstance(out, Vector)
    np.testing.assert_allclose(out.to_dense(), np.arange(8) + 5.0)
    assert last_loop_mode() == "hoisted"


def test_loop_multi_state_and_scalar():
    v = Vector.from_dense(np.ones(6))
    s = Scalar.from_value(0.0)

    def body(x, acc):
        x2 = x.apply(binary.times, right=2.0).new(x.dtype)
        acc2 = (acc + x2.reduce(monoid.plus)).new(acc.dtype)
        return x2, acc2

    x, acc = gb.loop(3, body, v, s)
    np.testing.assert_allclose(x.to_dense(), np.full(6, 8.0))
    # acc = 6*2 + 6*4 + 6*8 = 84
    assert acc.value == pytest.approx(84.0)


def test_loop_zero_iters_identity():
    v = Vector.from_dense(np.arange(4, dtype=np.float64))
    out = gb.loop(0, lambda x: x.apply(binary.plus, right=1.0).new(x.dtype), v)
    np.testing.assert_allclose(out.to_dense(), np.arange(4))


def test_loop_structure_fallback_when_struct_changes():
    # body grows the structure each iteration -> must fall back to carrying it
    v = Vector.from_coo([0], [1.0], dtm.FP64, size=6)
    ones = Vector.from_dense(np.ones(6))

    def body(x):
        # x | shift-by-broadcast: struct grows via union with full ones*0
        grown = x.ewise_add(ones, binary.first).new(x.dtype)
        return grown

    out = gb.loop(2, body, v)
    assert last_loop_mode() == "carried"
    assert out.nvals == 6


def test_loop_body_arity_error():
    v = Vector.from_dense(np.ones(4))
    with pytest.raises(TypeError, match="same number of state"):
        gb.loop(2, lambda x: (x, x), v)


def test_loop_empty_scalar_state_rejected():
    s = Scalar(dtm.FP64)
    with pytest.raises(TypeError, match="empty Scalar"):
        gb.loop(1, lambda x: x, s)


def test_loop_sparse_matrix_state_rejected():
    import graphblas_tpu.tx as txmod

    with txmod.config.set(dense_limit=0):
        A = Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], dtm.FP64, nrows=2, ncols=2)
    assert A._sparse is not None
    with pytest.raises(TypeError, match="sparse-format"):
        gb.loop(1, lambda x: x, A)


# ---------------------------------------------------------------------------
# gb.until
# ---------------------------------------------------------------------------


def test_until_scalar_condition():
    v = Vector.from_dense(np.array([1.0, 2.0, 3.0]))

    def cond(x):
        # keep doubling until the sum exceeds 100
        return (x.reduce(monoid.plus) < 100.0).new(dtm.BOOL)

    def body(x):
        return x.apply(binary.times, right=2.0).new(x.dtype)

    out = gb.until(cond, body, v)
    # sums: 6, 12, 24, 48, 96, 192 -> stops at 192
    np.testing.assert_allclose(out.to_dense(), np.array([1.0, 2.0, 3.0]) * 32)


def test_until_max_iters():
    v = Vector.from_dense(np.ones(3))

    def cond(x):
        return (x.reduce(monoid.plus) > 0.0).new(dtm.BOOL)  # always true

    def body(x):
        return x.apply(binary.plus, right=1.0).new(x.dtype)

    out = gb.until(cond, body, v, max_iters=4)
    np.testing.assert_allclose(out.to_dense(), np.full(3, 5.0))


# ---------------------------------------------------------------------------
# gb.compile
# ---------------------------------------------------------------------------


def test_compile_simple_function():
    @gb.compile
    def fused(x, y):
        s = x.ewise_add(y, binary.plus).new(x.dtype)
        return s.apply(binary.times, right=3.0).new(s.dtype)

    a = Vector.from_dense(np.arange(5, dtype=np.float64))
    b = Vector.from_dense(np.ones(5))
    out = fused(a, b)
    np.testing.assert_allclose(out.to_dense(), (np.arange(5) + 1) * 3.0)
    # second call hits the trace cache
    out2 = fused(a, b)
    np.testing.assert_allclose(out2.to_dense(), out.to_dense())
    assert len(fused._cache) == 1


def test_compile_returns_tuple_and_scalar():
    @gb.compile
    def fn(x):
        doubled = x.apply(binary.times, right=2.0).new(x.dtype)
        total = doubled.reduce(monoid.plus).new(x.dtype)
        return doubled, total

    v = Vector.from_dense(np.arange(4, dtype=np.float64))
    d, t = fn(v)
    np.testing.assert_allclose(d.to_dense(), np.arange(4) * 2.0)
    assert t.value == pytest.approx(12.0)


def test_compile_sparse_matrix_static_operand():
    import graphblas_tpu.tx as txmod

    src, dst, _ = _rand_graph()
    n = 120
    with txmod.config.set(dense_limit=0):
        AT = Matrix.from_coo(dst, src, np.float32(1.0), dtm.FP32, nrows=n, ncols=n)
    assert AT._sparse is not None

    @gb.compile
    def step(A, x):
        return A.mxv(x, semiring.plus_times).new(dtm.FP32)

    x = Vector.from_dense(np.ones(n, np.float32))
    out = step(AT, x)
    # oracle: column counts of AT = in-degree of dst
    expect = np.bincount(dst, minlength=n).astype(np.float32)
    got = out.to_dense(fill_value=0.0)
    np.testing.assert_allclose(got, expect)


def test_compile_loop_inside_compile():
    @gb.compile
    def fn(x):
        return gb.loop(3, lambda v: v.apply(binary.plus, right=1.0).new(v.dtype), x)

    v = Vector.from_dense(np.zeros(4))
    np.testing.assert_allclose(fn(v).to_dense(), np.full(4, 3.0))


# ---------------------------------------------------------------------------
# DSL algorithm parity (models/dsl vs eager oracles)
# ---------------------------------------------------------------------------


def _pull_matrix(src, dst, w, n, sparse, strategy):
    import graphblas_tpu.tx as txmod

    vals = np.float32(1.0) if w is None else w
    dup = binary.first if w is None else binary.min
    if sparse:
        with txmod.config.set(dense_limit=0):
            return Matrix.from_coo(dst, src, vals, dtm.FP32, nrows=n, ncols=n, dup_op=dup)
    return Matrix.from_coo(dst, src, vals, dtm.FP32, nrows=n, ncols=n, dup_op=dup)


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_pagerank_matches_model(sparse):
    import jax.numpy as jnp

    from graphblas_tpu.models import fast as mf
    from graphblas_tpu.models.graph import Graph

    src, dst, _ = _rand_graph(seed=3)
    n = 120
    AT = _pull_matrix(src, dst, None, n, sparse, None)
    r = dsl.pagerank(AT, max_iters=25)
    assert last_loop_mode() == "hoisted"  # rank vector is structurally stable
    rv = r.to_dense(fill_value=0.0)

    plan = mf.analyze(Graph.from_arrays(src, dst, n=n))
    outdeg = jnp.asarray(np.bincount(src, minlength=n).astype(np.int32))
    r_ref = np.asarray(mf.pagerank(plan, outdeg, n, max_iters=25, tol=0.0))
    np.testing.assert_allclose(rv, r_ref, atol=1e-6)


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_bfs_matches_model(sparse):
    from graphblas_tpu.models import fast as mf
    from graphblas_tpu.models.graph import Graph

    src, dst, _ = _rand_graph(seed=4)
    n = 120
    AT = _pull_matrix(src, dst, None, n, sparse, None)
    lv = dsl.bfs_level(AT, 0)
    plan = mf.analyze(Graph.from_arrays(src, dst, n=n))
    lv_ref = np.asarray(mf.bfs_level(plan, 0, n))
    idx, vals = lv.to_coo()
    got = np.full(n, -1, np.int64)
    got[idx.astype(np.int64)] = vals
    assert np.array_equal(got, lv_ref)


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_sssp_matches_oracle(sparse):
    src, dst, w = _rand_graph(seed=5, weighted=True)
    n = 120
    AT = _pull_matrix(src, dst, w, n, sparse, None)
    d = dsl.sssp(AT, 0)
    assert last_loop_mode() == "hoisted"  # dense distance vector
    dv = d.to_dense(fill_value=np.inf)

    # host Bellman-Ford oracle (min-combined duplicate edges)
    dist = np.full(n, np.inf)
    dist[0] = 0.0
    emin = {}
    for s, t, ww in zip(src, dst, w):
        if (s, t) not in emin or ww < emin[(s, t)]:
            emin[(s, t)] = ww
    for _ in range(n):
        changed = False
        for (s, t), ww in emin.items():
            if dist[s] + ww < dist[t] - 1e-9:
                dist[t] = dist[s] + ww
                changed = True
        if not changed:
            break
    reach = np.isfinite(dist)
    np.testing.assert_allclose(dv[reach], dist[reach], atol=1e-4)
    assert np.all(dv[~reach] > 1e30)


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_connected_components_matches_unionfind(sparse):
    src, dst, _ = _rand_graph(seed=6)
    n = 120
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    ATs = _pull_matrix(u, v, None, n, sparse, None)
    p = dsl.connected_components(ATs)
    pv = p.to_dense(fill_value=-1).astype(np.int64)

    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for s, t in zip(src, dst):
        rs, rt = find(int(s)), find(int(t))
        if rs != rt:
            parent[rs] = rt
    roots = np.array([find(i) for i in range(n)])
    minlab = {}
    for i in range(n):
        minlab.setdefault(roots[i], i)
    expect = np.array([minlab[roots[i]] for i in range(n)])
    assert np.array_equal(pv, expect)


def test_dsl_pagerank_plan_strategy():
    """Force the permutation-network plan path under the traced loop;
    results must match the generic path exactly."""
    import graphblas_tpu.tx as txmod

    src, dst, _ = _rand_graph(seed=7)
    n = 120
    with txmod.config.set(dense_limit=0):
        AT = Matrix.from_coo(dst, src, np.float32(1.0), dtm.FP32, nrows=n, ncols=n)
    r_generic = dsl.pagerank(AT, max_iters=20).to_dense(fill_value=0.0)
    with txmod.config.set(mxv_strategy="plan"):
        AT2 = Matrix.from_coo(dst, src, np.float32(1.0), dtm.FP32, nrows=n, ncols=n)
        with txmod.config.set(dense_limit=0):
            pass
        r_plan = dsl.pagerank(AT, max_iters=20).to_dense(fill_value=0.0)
    np.testing.assert_allclose(r_plan, r_generic, atol=1e-6)


def test_dsl_cc_plan_strategy():
    import graphblas_tpu.tx as txmod

    src, dst, _ = _rand_graph(seed=8)
    n = 120
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    with txmod.config.set(dense_limit=0):
        ATs = Matrix.from_coo(v, u, np.float32(1.0), dtm.FP32, nrows=n, ncols=n, dup_op=binary.first)
    p0 = dsl.connected_components(ATs).to_dense(fill_value=-1)
    with txmod.config.set(mxv_strategy="plan"):
        p1 = dsl.connected_components(ATs).to_dense(fill_value=-1)
    np.testing.assert_allclose(p0, p1)


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_fastsv_matches_unionfind(sparse):
    src, dst, _ = _rand_graph(seed=9)
    n = 120
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    ATs = _pull_matrix(u, v, None, n, sparse, None)
    f = dsl.fastsv(ATs)
    fv = f.to_dense(fill_value=-1).astype(np.int64)
    # oracle
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for s, t in zip(src, dst):
        rs, rt = find(int(s)), find(int(t))
        if rs != rt:
            parent[rs] = rt
    roots = np.array([find(i) for i in range(n)])
    minlab = {}
    for i in range(n):
        minlab.setdefault(roots[i], i)
    expect = np.array([minlab[roots[i]] for i in range(n)])
    assert np.array_equal(fv, expect)


def test_dsl_fastsv_plan_strategy():
    import graphblas_tpu.tx as txmod

    src, dst, _ = _rand_graph(seed=10)
    n = 120
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    with txmod.config.set(dense_limit=0):
        ATs = Matrix.from_coo(v, u, np.float32(1.0), dtm.FP32, nrows=n, ncols=n, dup_op=binary.first)
    f0 = dsl.fastsv(ATs).to_dense(fill_value=-1)
    with txmod.config.set(mxv_strategy="plan"):
        f1 = dsl.fastsv(ATs).to_dense(fill_value=-1)
    np.testing.assert_allclose(f0, f1)


def test_bfs_level_dense_hoisted():
    """The dense-frontier BFS recipe compiles in HOISTED mode
    (all structure channels trace-time constants) and matches the notebook
    recipe's levels."""
    import numpy as np

    from graphblas_tpu import Matrix, dtypes as dt
    from graphblas_tpu.models import dsl

    rng = np.random.default_rng(3)
    n = 60
    src = rng.integers(0, n, 240)
    dst = rng.integers(0, n, 240)
    keep = src != dst
    AT = Matrix.from_coo(dst[keep], src[keep], 1.0, dt.FP32, nrows=n, ncols=n, dup_op="first")
    run = dsl.bfs_level_dense_runner(AT, int(src[0]))
    assert run.mode == "hoisted"
    v = run()
    ref = dsl.bfs_level(AT, int(src[0]))
    ri, rl = ref.to_coo()
    dense = np.asarray(v._values)
    # dense recipe: -1 at unreached, levels elsewhere
    got = {int(i): int(dense[i]) for i in range(n) if dense[i] >= 0}
    assert got == {int(i): int(l) for i, l in zip(ri, rl)}


def test_until_unroll_matches_sequential():
    """unroll=K runs K body steps per while iteration — same fixpoint."""
    import numpy as np

    import graphblas_tpu as gb
    from graphblas_tpu import binary, monoid
    from graphblas_tpu.core import dtypes
    from graphblas_tpu.core.vector import Vector

    def mk_state():
        d0 = Vector.from_dense(np.array([0.0, 100.0, 100.0, 100.0, 100.0], np.float32))
        return d0

    def cond(d):
        return d.reduce(monoid.max).apply(binary.gt, right=4.0)

    def body(d):
        # shift-min chain: d[i] <- min(d[i], d[i-1] + 1); converges in 4 steps
        import graphblas_tpu as gb2
        from graphblas_tpu.core.matrix import Matrix

        n = d.size
        A = Matrix.from_coo(np.arange(1, n), np.arange(n - 1), np.ones(n - 1, np.float32), nrows=n, ncols=n)
        relaxed = A.mxv(d, "min_plus").new(dtypes.FP32)
        new = d.dup()
        new(accum=binary.min) << relaxed
        return new

    outs = {}
    for k in (1, 2, 3):
        r = gb.until_runner(cond, body, mk_state(), max_iters=64, unroll=k)
        outs[k] = np.asarray(r().to_dense())
        assert int(r.last_iters) % k == 0
    assert np.array_equal(outs[1], outs[2])
    assert np.array_equal(outs[1], outs[3])


def test_dsl_unroll_env_matches_default(monkeypatch):
    """GRAPHBLAS_TPU_DSL_UNROLL=2 gives identical BFS/SSSP/CC results."""
    import numpy as np

    from graphblas_tpu import binary
    from graphblas_tpu.core.matrix import Matrix
    from graphblas_tpu.models import dsl

    rng = np.random.default_rng(4)
    src = rng.integers(0, 60, 500)
    dst = rng.integers(0, 60, 500)
    AT = Matrix.from_coo(dst, src, np.ones(500, np.float32), nrows=60, ncols=60, dup_op=binary.plus)
    ATs = Matrix.from_coo(
        np.concatenate([dst, src]), np.concatenate([src, dst]),
        np.ones(1000, np.float32), nrows=60, ncols=60, dup_op=binary.first,
    )

    base = {
        "bfs": np.asarray(dsl.bfs_level_dense(AT, 0).to_dense(fill_value=-1)),
        "bfsc": sorted(zip(*(a.tolist() for a in dsl.bfs_level(AT, 0).to_coo()))),
        "sssp": np.asarray(dsl.sssp(AT, 0).to_dense()),
        "cc": np.asarray(dsl.connected_components(ATs).to_dense()),
    }
    monkeypatch.setenv("GRAPHBLAS_TPU_DSL_UNROLL", "2")
    assert np.array_equal(base["bfs"], np.asarray(dsl.bfs_level_dense(AT, 0).to_dense(fill_value=-1)))
    assert base["bfsc"] == sorted(zip(*(a.tolist() for a in dsl.bfs_level(AT, 0).to_coo())))
    assert np.array_equal(base["sssp"], np.asarray(dsl.sssp(AT, 0).to_dense()))
    assert np.array_equal(base["cc"], np.asarray(dsl.connected_components(ATs).to_dense()))


def test_compiled_loop_consts_all_committed():
    """Every hoisted const must be a jax.Array: host leaves (numpy arrays OR
    jax TypedNdArray literals) re-upload to the device on EVERY
    execution."""
    import jax

    src, dst, w = _rand_graph(80, 400, seed=5, weighted=True)
    AT = Matrix.from_coo(dst, src, w, nrows=80, ncols=80, dup_op=binary.plus)
    runners = [
        dsl.pagerank_runner(AT, max_iters=3),
        dsl.sssp_runner(AT, 0).runner,
        dsl.bfs_level_dense_runner(AT, 0).runner,
        dsl.connected_components_runner(AT).runner,
    ]
    for r in runners:
        cl = r if hasattr(r, "_consts") else r.runner
        bad = [type(c).__name__ for c in cl._consts if not isinstance(c, jax.Array)]
        assert not bad, f"host-side consts would re-upload per call: {bad}"
        for lv in cl._leaves0:
            assert isinstance(lv, jax.Array)
        if cl.mode == "hoisted":
            for v in cl._values0:
                assert isinstance(v, jax.Array)
            for s in cl._structs_dev:
                assert s is None or isinstance(s, jax.Array)


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_cc_directed_wcc(sparse):
    """connected_components on a NON-symmetric adjacency computes weakly-
    connected components (the alternating pull/push recipe's contract —
    the symmetrization is never materialized)."""
    src, dst, _ = _rand_graph(n=100, e=150, seed=9)
    n = 100
    AT = _pull_matrix(dst, src, None, n, sparse, None)
    pv = dsl.connected_components(AT).to_dense(fill_value=-1).astype(np.int64)

    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for s, t in zip(src, dst):
        rs, rt = find(int(s)), find(int(t))
        if rs != rt:
            parent[rs] = rt
    roots = np.array([find(i) for i in range(n)])
    minlab = {}
    for i in range(n):
        minlab.setdefault(roots[i], i)
    expect = np.array([minlab[roots[i]] for i in range(n)])
    assert np.array_equal(pv, expect)


def test_dsl_seed_round_ab(monkeypatch):
    """The build-time seed (round 1 baked into the initial state) must not
    change any DSL result: bfs_level_dense / sssp / connected_components
    with GRAPHBLAS_TPU_SEED_ROUND=0 and =1 agree, including corner sources
    (sink, no in-edges, isolated)."""
    src, dst, w = _rand_graph(n=90, e=300, seed=12, weighted=True)
    keep = ~np.isin(src, [80, 83]) & ~np.isin(dst, [81, 83])
    src, dst, w = src[keep], dst[keep], w[keep]
    n = 90
    AT = _pull_matrix(dst, src, w, n, True, None)
    got = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GRAPHBLAS_TPU_SEED_ROUND", flag)
        res = {}
        for s in (0, 80, 81, 83):
            res[("bfs", s)] = np.asarray(dsl.bfs_level_dense(AT, s).to_dense(fill_value=-1))
            res[("sssp", s)] = np.asarray(dsl.sssp(AT, s).to_dense())
        res["cc"] = np.asarray(dsl.connected_components(AT).to_dense(fill_value=-1))
        got[flag] = res
    for k in got["0"]:
        np.testing.assert_allclose(got["1"][k], got["0"][k], rtol=1e-5, err_msg=str(k))
