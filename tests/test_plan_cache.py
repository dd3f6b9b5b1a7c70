"""Pattern-keyed plan cache (symbolic/numeric split) regression tests.

The permutation networks are pure pattern analysis; the disk cache is keyed
by the COO pattern and re-derives the weight channel at load
(ops/fastspmv.load_spmv_plan(w=...)).  Two same-pattern matrices with
different values must share one cached plan AND produce their own correct
numerics.
"""

import os

import numpy as np
import pytest

import graphblas_tpu as gb  # noqa: F401
from graphblas_tpu import binary, semiring, tx
from graphblas_tpu.core import dtypes
from graphblas_tpu.core.matrix import Matrix
from graphblas_tpu.core.vector import Vector


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAPHBLAS_TPU_PLAN_CACHE", str(tmp_path))
    return tmp_path


def _dense_mxv(rows, cols, vals, x, n):
    y = np.zeros(n)
    np.add.at(y, rows, vals * x[cols])
    return y


def test_same_pattern_shares_plan_file(plan_cache):
    rng = np.random.default_rng(7)
    n, e = 5000, 4000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w1 = rng.random(e).astype(np.float32)
    w2 = rng.random(e).astype(np.float32)
    x = Vector.from_dense(rng.random(n).astype(np.float32))
    with tx.config.set(mxv_strategy="plan"):
        A1 = Matrix.from_coo(dst, src, w1, nrows=n, ncols=n, dup_op=binary.plus)
        A2 = Matrix.from_coo(dst, src, w2, nrows=n, ncols=n, dup_op=binary.plus)
        y1 = np.asarray(A1.mxv(x, semiring.plus_times).new(dtypes.FP32).to_dense(fill_value=0.0))
        files_after_first = {f for f in os.listdir(plan_cache) if f.startswith("gbtpu_plan3_")}
        y2 = np.asarray(A2.mxv(x, semiring.plus_times).new(dtypes.FP32).to_dense(fill_value=0.0))
        files_after_second = {f for f in os.listdir(plan_cache) if f.startswith("gbtpu_plan3_")}
    # one plan file serves both matrices (same pattern, different values)
    assert files_after_first == files_after_second
    assert len(files_after_first) == 1
    # each matrix gets ITS OWN correct numerics
    r1, c1, v1 = (np.asarray(a) for a in A1.to_coo())
    r2, c2, v2 = (np.asarray(a) for a in A2.to_coo())
    xe = np.asarray(x.to_dense())
    assert np.allclose(y1, _dense_mxv(r1, c1, v1, xe, n), rtol=2e-5, atol=2e-5)
    assert np.allclose(y2, _dense_mxv(r2, c2, v2, xe, n), rtol=2e-5, atol=2e-5)
    assert not np.allclose(y1, y2)  # genuinely different weights


def test_cache_roundtrip_from_disk(plan_cache):
    rng = np.random.default_rng(8)
    n, e = 5000, 2500
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    x = Vector.from_dense(rng.random(n).astype(np.float32))
    with tx.config.set(mxv_strategy="plan"):
        A = Matrix.from_coo(dst, src, w, nrows=n, ncols=n, dup_op=binary.plus)
        y_build = np.asarray(A.mxv(x, semiring.plus_times).new(dtypes.FP32).to_dense(fill_value=0.0))
        # a FRESH equal matrix must hit the disk cache (no in-memory reuse)
        B = Matrix.from_coo(dst, src, w, nrows=n, ncols=n, dup_op=binary.plus)
        y_load = np.asarray(B.mxv(x, semiring.plus_times).new(dtypes.FP32).to_dense(fill_value=0.0))
    assert np.allclose(y_build, y_load, rtol=1e-6)


def test_bool_matrix_shares_pattern_plan(plan_cache):
    rng = np.random.default_rng(9)
    n, e = 5000, 1800
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    x = Vector.from_dense(rng.random(n).astype(np.float32))
    with tx.config.set(mxv_strategy="plan"):
        A = Matrix.from_coo(dst, src, w, nrows=n, ncols=n, dup_op=binary.plus)
        _ = A.mxv(x, semiring.plus_times).new(dtypes.FP32).to_dense(fill_value=0.0)
        # bool matrix, same pattern: bool values still carry an int32 weight
        # channel, so it SHARES the pattern-keyed plan file — and must get
        # its own correct numerics through the weight override
        Ab = Matrix.from_coo(dst, src, np.ones(e, bool), nrows=n, ncols=n, dup_op=binary.lor)
        yb = np.asarray(
            Ab.mxv(x, semiring.max_second).new(dtypes.FP32).to_dense(fill_value=0.0)
        )
    files = [f for f in os.listdir(plan_cache) if f.startswith("gbtpu_plan3_")]
    assert len(files) == 1
    rows, cols, _ = (np.asarray(a) for a in Ab.to_coo())
    xe = np.asarray(x.to_dense())
    exp = np.full(n, -np.inf)
    np.maximum.at(exp, rows, xe[cols])
    exp = np.where(np.isinf(exp), 0.0, exp)
    assert np.allclose(yb, exp)


def test_loop_net_skipped_for_dsl_plans(plan_cache):
    rng = np.random.default_rng(10)
    n, e = 5000, 2000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if True:
        A = Matrix.from_coo(dst, src, rng.random(e).astype(np.float32), nrows=n, ncols=n, dup_op=binary.plus)
        plan = A._sparse.plan("pull")
    assert plan.loop_plan is None  # DSL dispatch never touches the loop net
    assert plan.place_plan is not None and plan.collect_plan is not None


def test_auto_eager_mxv_builds_no_plan(rng):
    """Under mxv_strategy="auto" an eager mxv runs gather+segment and builds
    no network plan; the explicit "plan" strategy gives the same answer."""
    from graphblas_tpu import Vector, binary, dtypes, semiring
    from graphblas_tpu import tx as txmod
    from graphblas_tpu.core.matrix import Matrix

    n, e = 300, 2000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = (rng.random(e) + 0.1).astype(np.float32)
    with txmod.config.set(dense_limit=0):
        A = Matrix.from_coo(dst, src, w, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.plus)
    sp = A._sparse
    x = Vector.from_dense(rng.random(n).astype(np.float32))
    with txmod.config.set(mxv_strategy="auto"):
        y_auto = A.mxv(x, semiring.plus_times).new()
    assert sp._plans == {}
    with txmod.config.set(mxv_strategy="plan"):
        y_plan = A.mxv(x, semiring.plus_times).new()
    assert set(sp._plans) == {"pull"}
    np.testing.assert_allclose(
        np.asarray(y_plan._values), np.asarray(y_auto._values), rtol=1e-5
    )
