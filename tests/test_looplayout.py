"""Edge-layout lowering for compiled DSL loops (core/looplayout.py).

The compiler may re-trace a loop body with state carried in the edge space
(2 permutation networks per SpMV instead of 3 — the hand-written models'
loop layout).  These tests assert the upgrade is (a) applied where eligible,
(b) bit-identical to the n-space lowering, and (c) rejected — with correct
results — for everything the layout cannot express.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import binary, monoid, semiring
from graphblas_tpu.core import dtypes as dtm
from graphblas_tpu.core.matrix import Matrix
from graphblas_tpu.core.scalar import Scalar
from graphblas_tpu.core.vector import Vector
from graphblas_tpu.models import dsl


@pytest.fixture(autouse=True)
def _force_sparse_matrices(monkeypatch):
    # matrices (n*n cells) sparse-backed, vectors (n) dense — the big-graph
    # storage shape the edge layout targets.  The edge layout is a
    # plan-engine feature: pin mxv_strategy="plan" (under "auto" compiled
    # loops stay on gather+segment; see test_auto_loop_builds_no_plan)
    old = gb.tx.config.get("dense_limit")
    gb.tx.config["dense_limit"] = 20000
    monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", "1")
    with gb.tx.config.set(mxv_strategy="plan"):
        yield
    gb.tx.config["dense_limit"] = old


def test_auto_loop_builds_no_plan():
    """Under mxv_strategy="auto" a compiled DSL loop runs gather+segment:
    no network plan is built on the host and the layout stays n-space."""
    r, c, w, n = _graph(seed=31)
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    with gb.tx.config.set(mxv_strategy="auto"):
        runner = dsl.pagerank_runner(AT, max_iters=5)
        got = np.asarray(runner().to_dense(fill_value=0.0))
    assert runner.layout == "n"
    assert AT._sparse._plans == {}
    with gb.tx.config.set(mxv_strategy="plan"):
        ref = np.asarray(dsl.pagerank_runner(AT, max_iters=5)().to_dense(fill_value=0.0))
    assert set(AT._sparse._plans) == {"pull"}
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _graph(n=200, e=900, seed=7, indeg0_tail=50):
    """Random digraph where the last ``indeg0_tail`` vertices have NO
    in-edges (exercises the total-plan state slots)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e) % (n - indeg0_tail)
    c = rng.integers(0, n, e)
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    w = (rng.random(len(r)) + 0.1).astype(np.float32)
    return r, c, w, n


def _with_layout(monkeypatch, flag, fn):
    monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", flag)
    return fn()


def test_pagerank_edge_layout_matches_n_space(monkeypatch):
    r, c, w, n = _graph()
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    assert AT._sparse is not None

    def run():
        runner = dsl.pagerank_runner(AT, max_iters=15)
        return runner.layout, np.asarray(runner().to_dense(fill_value=0.0))

    lay0, base = _with_layout(monkeypatch, "0", run)
    lay1, new = _with_layout(monkeypatch, "1", run)
    assert lay0 == "n" and lay1 == "edge"
    np.testing.assert_allclose(base, new, atol=1e-6)


def test_sssp_edge_layout_bit_identical(monkeypatch):
    r, c, w, n = _graph(seed=3)
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)

    def run():
        runner = dsl.sssp_runner(AT, 2)
        return runner.runner.layout, np.asarray(runner().to_dense(fill_value=np.inf))

    lay0, base = _with_layout(monkeypatch, "0", run)
    lay1, new = _with_layout(monkeypatch, "1", run)
    assert lay0 == "n" and lay1 == "edge"
    assert np.array_equal(base, new)


def test_bfs_dense_edge_layout_bit_identical(monkeypatch):
    r, c, _, n = _graph(seed=5)
    AT = Matrix.from_coo(r, c, np.ones(len(r), np.float32), nrows=n, ncols=n)

    def run():
        runner = dsl.bfs_level_dense_runner(AT, 2)
        return runner.runner.layout, np.asarray(runner().to_dense(fill_value=-1))

    lay0, base = _with_layout(monkeypatch, "0", run)
    lay1, new = _with_layout(monkeypatch, "1", run)
    assert lay0 == "n" and lay1 == "edge"
    assert np.array_equal(base, new)


def test_two_direction_loop_rejects_edge_layout():
    # cc pulls AND pushes (two plans) — must stay in the n space and be right
    r, c, _, n = _graph(seed=11)
    AT = Matrix.from_coo(r, c, np.ones(len(r), np.float32), nrows=n, ncols=n)
    runner = dsl.connected_components_runner(AT)
    assert runner.runner.layout == "n"
    labels = np.asarray(runner().to_dense(fill_value=-1))
    # oracle: union-find over the symmetrized graph
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(r, c):
        parent[find(a)] = find(b)
    roots = np.array([find(v) for v in range(n)])
    # same partition: labels equal iff roots equal
    import itertools

    rng = np.random.default_rng(0)
    for a, b in zip(rng.integers(0, n, 300), rng.integers(0, n, 300)):
        assert (labels[a] == labels[b]) == (roots[a] == roots[b])


def test_indexed_assign_in_body_rejects_edge_layout():
    r, c, w, n = _graph(seed=13)
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    d0 = Vector.from_dense(np.zeros(n, np.float32))

    def body(x):
        y = AT.mxv(x, semiring.plus_times).new(dtm.FP32)
        z = x.ewise_add(y, binary.plus).new(dtm.FP32)
        out = z.dup()
        out[3] = 7.0  # vertex-indexed write: not expressible in edge layout
        return out

    runner = gb.loop_runner(3, body, d0)
    assert runner.layout == "n"  # fell back, still correct
    out = np.asarray(runner().to_dense(fill_value=0.0))
    # eager oracle
    x = np.zeros(n, np.float64)
    A = np.zeros((n, n))
    A[r, c] = w
    for _ in range(3):
        y = A @ x
        x = x + y
        x[3] = 7.0
    np.testing.assert_allclose(out, x.astype(np.float32), atol=1e-4)


def test_positional_apply_in_body_rejects_edge_layout():
    from graphblas_tpu import unary

    r, c, w, n = _graph(seed=17)
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    d0 = Vector.from_dense(np.zeros(n, np.float32))

    def body(x):
        y = AT.mxv(x, semiring.plus_times).new(dtm.FP32)
        idx = x.apply("positioni").new(dtm.FP32)  # slot ids != vertex ids
        return y.ewise_add(idx, binary.plus).new(dtm.FP32)

    runner = gb.loop_runner(2, body, d0)
    assert runner.layout == "n"
    out = np.asarray(runner().to_dense(fill_value=0.0))
    x = np.zeros(n, np.float64)
    A = np.zeros((n, n))
    A[r, c] = w
    for _ in range(2):
        x = A @ x + np.arange(n)
    np.testing.assert_allclose(out, x.astype(np.float32), rtol=1e-4)


def test_edge_layout_complement_mask_in_body(monkeypatch):
    # complemented value mask inside the body: the universe guard must keep
    # garbage slots out of the structure
    r, c, w, n = _graph(seed=19)
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    d0 = Vector.from_dense(np.full(n, 10.0, np.float32))
    flag0 = Vector.from_dense(np.zeros(n, np.float32))

    def body(x, f):
        y = AT.mxv(x, semiring.plus_times).new(dtm.FP32)
        big = y.apply(binary.gt, right=5.0).new(dtm.BOOL)
        x2 = x.dup()
        x2(~big.V)[:] = 1.0  # complement mask: where y <= 5 (or absent)
        s = x2.reduce(monoid.plus).new(dtm.FP32)
        f2 = f.apply(binary.plus, right=s).new(dtm.FP32)
        return x2, f2

    def run():
        runner = gb.loop_runner(3, body, d0, flag0)
        x, f = runner()
        return runner.layout, np.asarray(x.to_dense(fill_value=0.0)), np.asarray(
            f.to_dense(fill_value=0.0)
        )

    lay0, x0, f0 = _with_layout(monkeypatch, "0", run)
    lay1, x1, f1 = _with_layout(monkeypatch, "1", run)
    np.testing.assert_allclose(x0, x1, atol=1e-4)
    np.testing.assert_allclose(f0, f1, rtol=1e-5)


def test_edge_layout_runner_with_new_state(monkeypatch):
    # runner(*state): the n->edge conversion happens device-side per call
    r, c, w, n = _graph(seed=23)
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    v0 = Vector.from_dense(np.ones(n, np.float32))

    def body(x):
        y = AT.mxv(x, semiring.plus_times).new(dtm.FP32)
        return y.ewise_add(x, binary.plus).new(dtm.FP32)

    runner = gb.loop_runner(2, body, v0)
    assert runner.layout == "edge"
    v1 = Vector.from_dense(np.linspace(0, 1, n).astype(np.float32))
    out = np.asarray(runner(v1).to_dense(fill_value=0.0))
    A = np.zeros((n, n))
    A[r, c] = w
    x = np.linspace(0, 1, n)
    for _ in range(2):
        x = A @ x + x
    np.testing.assert_allclose(out, x.astype(np.float32), rtol=1e-4)


def test_edge_layout_total_plan_indeg0_values_preserved():
    # vertices with no in-edges must keep their evolving state (total-plan
    # state slots) — the value at an in-degree-0 vertex changes every round
    r, c, w, n = _graph(seed=29, indeg0_tail=60)
    AT = Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    v0 = Vector.from_dense(np.arange(n, dtype=np.float32))

    def body(x):
        y = AT.mxv(x, semiring.plus_times).new(dtm.FP32)
        return y.ewise_add(x.apply(binary.times, right=2.0), binary.plus).new(dtm.FP32)

    runner = gb.loop_runner(3, body, v0)
    assert runner.layout == "edge"
    out = np.asarray(runner().to_dense(fill_value=0.0))
    A = np.zeros((n, n))
    A[r, c] = w
    x = np.arange(n, dtype=np.float64)
    for _ in range(3):
        x = A @ x + 2.0 * x
    np.testing.assert_allclose(out, x.astype(np.float32), rtol=2e-4)
