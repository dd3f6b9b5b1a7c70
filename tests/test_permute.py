"""Permutation-network engine and fast SpMV tests."""

import numpy as np
import pytest

import graphblas_tpu as gb  # noqa: F401

from graphblas_tpu.native import euler_color
from graphblas_tpu.ops.fastspmv import build_spmv_plan, spmv
from graphblas_tpu.ops.permute import apply_plan, build_permutation_plan, padded_size


def test_euler_color_proper(rng):
    R, k = 16, 8
    E = R * k
    in_rows = np.repeat(np.arange(R, dtype=np.int32), k)
    out_rows = in_rows[rng.permutation(E)]
    colors = euler_color(in_rows, out_rows, R, k)
    for r in range(R):
        assert sorted(colors[in_rows == r].tolist()) == list(range(k))
        assert sorted(colors[out_rows == r].tolist()) == list(range(k))


@pytest.mark.parametrize("n", [128, 512, 1024, 16384])
def test_plan_roundtrip(rng, n):
    import jax.numpy as jnp

    perm = rng.permutation(n)
    plan = build_permutation_plan(perm)
    x = np.arange(n, dtype=np.float32)
    out = np.asarray(apply_plan(jnp.asarray(x), plan))
    np.testing.assert_array_equal(out, x[perm])


@pytest.mark.slow
def test_plan_two_level(rng):
    import jax.numpy as jnp

    n = 128 * 128 * 128
    perm = rng.permutation(n)
    plan = build_permutation_plan(perm, validate=False)
    x = rng.random(n).astype(np.float32)
    out = np.asarray(apply_plan(jnp.asarray(x), plan))
    np.testing.assert_array_equal(out, x[perm])


def test_padded_size():
    assert padded_size(100) == 128
    assert padded_size(128 * 128) == 128 * 128
    assert padded_size(128 * 128 + 1) == 2 * 128 * 128
    assert padded_size(1 << 24) == 8 * 128**3
    r = padded_size(3_000_000) // 128
    m = r
    while m > 128:
        assert m % 128 == 0
        m //= 128


@pytest.mark.parametrize(
    "add,mul", [("plus", "times"), ("min", "plus"), ("max", "first"), ("plus", "second")]
)
def test_spmv_vs_oracle(rng, add, mul):
    import jax.numpy as jnp

    n, e = 300, 2000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) * 5).astype(np.float32)
    plan = build_spmv_plan(src, dst, w, n=n)
    x = (rng.random(n) * 5).astype(np.float32)
    y = np.asarray(spmv(plan, jnp.asarray(x), add, mul))

    mul_np = {
        "times": lambda xs, ws: ws * xs,
        "plus": lambda xs, ws: ws + xs,
        "first": lambda xs, ws: xs,
        "second": lambda xs, ws: ws,
    }[mul]
    contrib = mul_np(x[src], w)
    if add == "plus":
        ref = np.zeros(n, np.float32)
        np.add.at(ref, dst, contrib)
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)
    else:
        fill = np.inf if add == "min" else -np.inf
        ref = np.full(n, fill, np.float32)
        (np.minimum if add == "min" else np.maximum).at(ref, dst, contrib)
        mask = np.isfinite(ref)
        np.testing.assert_allclose(y[mask], ref[mask], rtol=1e-4)
        assert np.array_equal(np.isfinite(y), mask)


def test_spmv_empty_rows(rng):
    """Nodes with no in/out edges must produce identity outputs."""
    import jax.numpy as jnp

    n = 200
    src = np.array([0, 1, 0], np.int32)
    dst = np.array([5, 5, 7], np.int32)
    w = np.array([1.0, 2.0, 3.0], np.float32)
    plan = build_spmv_plan(src, dst, w, n=n)
    x = np.arange(n, dtype=np.float32)
    y = np.asarray(spmv(plan, jnp.asarray(x), "plus", "times"))
    expected = np.zeros(n, np.float32)
    expected[5] = 1.0 * x[0] + 2.0 * x[1]
    expected[7] = 3.0 * x[0]
    np.testing.assert_allclose(y, expected, rtol=1e-6)


# ---------------------------------------------------------------------------
# Loop-layout (v3) algorithm paths: state in the edge space, ONE loop network
# per iteration (fastspmv.spmv_state/state_to_start/state_to_n)
# ---------------------------------------------------------------------------


def _nasty_graph(rng, n=150, e=600):
    """Random graph with isolated vertices, dangling vertices, and vertices
    with in-edges only / out-edges only (the loop-layout edge cases)."""
    # confine edges to a subrange so ~20% of vertices are isolated
    src = rng.integers(0, int(n * 0.8), e).astype(np.int32)
    dst = rng.integers(0, int(n * 0.9), e).astype(np.int32)
    # a pure sink (in-edges only): retarget some edges to n-1... keep random
    w = (rng.random(e) * 3 + 0.05).astype(np.float32)
    return src, dst, w


def test_loop_bfs_matches_v1(rng):
    from graphblas_tpu.models import fast as mf

    n = 150
    src, dst, w = _nasty_graph(rng, n)
    plan = build_spmv_plan(src, dst, w, n=n)
    assert plan.loop_plan is not None
    for source in [int(src[0]), int(dst[0]), n - 1, 0]:
        got = np.asarray(mf._bfs_loop_v3(plan, source, n))
        ref = np.array(mf._bfs_loop(plan, source, n))
        ref[source] = 0  # v1 also reports 0 for the source
        np.testing.assert_array_equal(got, ref, err_msg=f"source={source}")


def test_loop_bfs_source_without_out_edges(rng):
    from graphblas_tpu.models import fast as mf

    n = 140
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    plan = build_spmv_plan(src, dst, None, n=n)
    # vertex 10 has no edges at all: BFS from it = only itself
    got = np.asarray(mf._bfs_loop_v3(plan, 10, n))
    expected = np.full(n, -1, np.int32)
    expected[10] = 0
    np.testing.assert_array_equal(got, expected)


def test_loop_sssp_matches_v1(rng):
    from graphblas_tpu.models import fast as mf

    n = 150
    src, dst, w = _nasty_graph(rng, n)
    plan = build_spmv_plan(src, dst, w, n=n)
    for source in [int(src[0]), n - 1]:
        got = np.asarray(mf._sssp_loop_v3(plan, source, n))
        ref = np.array(mf._sssp_loop(plan, source, n))
        ref[source] = 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=f"source={source}")


def test_loop_donor_modes_match(rng):
    """Donor-routed x_start (no select) == the select path, for every mode.

    Donor routing: no-state start slots read non-last slots, which the scan
    state kernels keep at the mode identity (BFS 0 / SSSP STATE_BIG)."""
    from graphblas_tpu.models import fast as mf

    n = 150
    src, dst, w = _nasty_graph(rng, n)
    # guarantee out-only vertices (no-state starts): n-10..n-6 each have an
    # out-edge and (src range < 0.8n) no in-edge
    extra_src = np.arange(n - 10, n - 5, dtype=np.int32)
    extra_dst = np.arange(5, dtype=np.int32)
    src = np.concatenate([src, extra_src])
    dst = np.concatenate([dst, extra_dst])
    w = np.concatenate([w, np.full(5, 0.5, np.float32)])
    plan = build_spmv_plan(src, dst, w, n=n)
    assert plan.loop_donors
    for source in [int(src[0]), n - 10, 0]:
        ref_b = np.asarray(mf._bfs_loop_v3(plan, source, n, mode="select"))
        ref_s = np.asarray(mf._sssp_loop_v3(plan, source, n, mode="select"))
        for mode in ("donor", "donor_post"):
            got_b = np.asarray(mf._bfs_loop_v3(plan, source, n, mode=mode))
            np.testing.assert_array_equal(got_b, ref_b, err_msg=f"bfs {mode} source={source}")
            got_s = np.asarray(mf._sssp_loop_v3(plan, source, n, mode=mode))
            np.testing.assert_allclose(
                got_s, ref_s, rtol=1e-6, err_msg=f"sssp {mode} source={source}"
            )


def test_loop_donor_after_roundtrip(rng, tmp_path):
    """Cache round-trip preserves donor routing; pre-r5 caches (flag absent)
    keep the select path."""
    from graphblas_tpu.models import fast as mf
    from graphblas_tpu.ops.fastspmv import load_spmv_plan, save_spmv_plan

    n = 130
    src, dst, w = _nasty_graph(rng, n, 400)
    plan = build_spmv_plan(src, dst, w, n=n)
    path = tmp_path / "plan_donor.npz"
    save_spmv_plan(plan, str(path))
    plan2 = load_spmv_plan(str(path))
    assert plan2.loop_donors
    s = int(src[0])
    np.testing.assert_allclose(
        np.asarray(mf._sssp_loop_v3(plan2, s, n, mode="donor")),
        np.asarray(mf._sssp_loop_v3(plan, s, n, mode="select")),
        rtol=1e-6,
    )
    # simulate a pre-r5 cache: strip the flag -> loader must disable donors
    data = dict(np.load(str(path), allow_pickle=False))
    data.pop("loop_donors")
    np.savez(str(path), **data)
    plan3 = load_spmv_plan(str(path))
    assert not plan3.loop_donors


def test_loop_pagerank_matches_v1(rng):
    import jax.numpy as jnp

    from graphblas_tpu.models import fast as mf

    n = 150
    src, dst, w = _nasty_graph(rng, n)
    plan = build_spmv_plan(src, dst, w, n=n)
    outdeg = jnp.asarray(np.bincount(src, minlength=n).astype(np.int32))
    got, _ = mf._pagerank_loop_v3(plan, n, jnp.float32(0.85), 0.0, 20)
    ref, _ = mf._pagerank_loop(plan, outdeg, n, jnp.float32(0.85), 0.0, 20)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4, atol=1e-9)
    assert abs(float(np.asarray(got).sum()) - 1.0) < 1e-3


def test_loop_pagerank_tol_mode(rng):
    import jax.numpy as jnp

    from graphblas_tpu.models import fast as mf

    n = 150
    src, dst, w = _nasty_graph(rng, n)
    plan = build_spmv_plan(src, dst, w, n=n)
    r, iters = mf._pagerank_loop_v3(plan, n, jnp.float32(0.85), 1e-7, 200)
    outdeg = jnp.asarray(np.bincount(src, minlength=n).astype(np.int32))
    ref, _ = mf._pagerank_loop(plan, outdeg, n, jnp.float32(0.85), 1e-7, 200)
    np.testing.assert_allclose(np.asarray(r), np.asarray(ref), rtol=1e-3, atol=1e-8)
    assert 1 < int(iters) < 200


def test_loop_plan_roundtrip(rng, tmp_path):
    """save/load must preserve the v3 loop-layout fields."""
    import jax.numpy as jnp

    from graphblas_tpu.models import fast as mf
    from graphblas_tpu.ops.fastspmv import load_spmv_plan, save_spmv_plan

    n = 130
    src, dst, w = _nasty_graph(rng, n, 400)
    plan = build_spmv_plan(src, dst, w, n=n)
    path = tmp_path / "plan_v3.npz"
    save_spmv_plan(plan, str(path))
    plan2 = load_spmv_plan(str(path))
    assert plan2.loop_plan is not None
    assert plan2.k_iso_dangling == plan.k_iso_dangling
    s = int(src[0])
    np.testing.assert_array_equal(
        np.asarray(mf._bfs_loop_v3(plan, s, n)), np.asarray(mf._bfs_loop_v3(plan2, s, n))
    )
    np.testing.assert_allclose(
        np.asarray(mf._sssp_loop_v3(plan, s, n)), np.asarray(mf._sssp_loop_v3(plan2, s, n))
    )


def test_rowsel_shuffle_cache_converts_to_select(tmp_path, monkeypatch):
    """r3 plan caches saved lane-shuffle ROWSEL tables; loading them must
    invert back to the (measured-fast) m-way select form bit-exactly."""
    import numpy as np

    from graphblas_tpu.ops import fastspmv as fsv
    from graphblas_tpu.ops.permute import (
        _apply_RSEL_np,
        _apply_ROWSEL_np,
        _rowsel_table,
        _rowsel_unshuffle,
        apply_plan,
        build_permutation_plan,
        padded_size,
    )

    rng = np.random.default_rng(11)
    # admissible size with m=4 (divides 128): n = 4 * 128 * 128
    n = 4 * 128 * 128
    perm = rng.permutation(n)

    # build in shuffle mode, save, then load in default (select) mode
    monkeypatch.setenv("GRAPHBLAS_TPU_ROWSEL_SHUFFLE", "1")
    plan_shuf = build_permutation_plan(perm)
    kinds = [s[0] for s in plan_shuf.stages]
    assert "ROWSEL" in kinds
    arrays = {}
    fsv._pack_network(arrays, plan_shuf, "t_")
    monkeypatch.delenv("GRAPHBLAS_TPU_ROWSEL_SHUFFLE")
    npz = tmp_path / "net.npz"
    np.savez(npz, **arrays)
    data = np.load(npz)
    loaded = fsv._unpack_network(data, "t_", n)
    kinds2 = [s[0] for s in loaded.stages]
    assert "RSEL" in kinds2 and "ROWSEL" not in kinds2

    x = rng.random(n).astype(np.float32)
    out = np.asarray(apply_plan(x, loaded))
    np.testing.assert_array_equal(out, x[perm])

    # direct table round-trip
    for m in (2, 4, 8):
        s2 = n // (128 * m)
        st = rng.integers(0, m, size=(m, s2, 128)).astype(np.int32)
        # make each column a permutation of groups so it's a valid exchange
        st = np.argsort(rng.random((m, s2, 128)), axis=0).astype(np.int32)
        shuf = _rowsel_table(st, m)
        st2 = _rowsel_unshuffle(shuf, m)
        np.testing.assert_array_equal(st, st2)
        e = rng.random(n).astype(np.float32)
        np.testing.assert_array_equal(
            _apply_ROWSEL_np(e, shuf, m), _apply_RSEL_np(e, st, m)
        )
