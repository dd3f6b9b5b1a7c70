"""Smoke test of graphblas_tpu on one NVIDIA GPU.

Drives the user DSL path at a real graph size and checks every result
against a scipy/numpy oracle built from the same edges in the same run:

- ``dsl``: a Graph500/Kronecker RMAT graph (scale 22, edge factor 16: the
  size of LDBC Graphalytics' graph500-22) as a ``Matrix``; the models/dsl.py
  runners for PageRank, level BFS, SSSP and connected components, with their
  default dtypes and ``mxv_strategy="auto"``;
- ``tc``: triangle counting through the DSL (masked plus_pair SpGEMM) on the
  symmetrised RMAT graph at scale 16;
- ``plan``: the permutation-network engine (``mxv_strategy="plan"`` and
  models/fast.py) at scale 18;
- ``kernels``: the segmented fill/reduce at 2^26 slots and the Triton
  tropical mxm at 2048^3 and 4096^3 against their plain references.

Run on a machine with one GPU:

    python chip_smoke.py

Each phase raises on a mismatch and the script then exits non-zero; it also
exits non-zero, printing no result, when JAX's first device is not a GPU.
The last line of standard output is one JSON object naming the device.
Every phase is a function of its size, so the CPU tests call them small.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 1
DAMPING = 0.85
PR_ITERS = 50
_BIG = float(np.float32(3.4e38) / 4)  # models/dsl.py's "unreached" distance


def _log(msg):
    print(msg, flush=True)


def _now():
    return time.perf_counter()


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return "not measured" if not stats else stats.get("peak_bytes_in_use", "not measured")


# ---------------------------------------------------------------------------
# graphs and oracles (host numpy/scipy, independent of the code under test)
# ---------------------------------------------------------------------------


def rmat_edges(scale, edge_factor=16, seed=SEED):
    """Deduplicated directed RMAT edges (src, dst, w) with weights in [1, 10)
    from models/graph.rmat, sorted by (dst, src); a duplicate edge keeps its
    smallest weight."""
    from graphblas_tpu.models.graph import rmat

    n = 1 << scale
    g = rmat(scale, edge_factor, seed=seed, weighted=True)
    valid = np.asarray(g.valid)
    key = np.asarray(g.dst)[valid].astype(np.int64) * n + np.asarray(g.src)[valid]
    w = np.asarray(g.weights)[valid]
    del g
    order = np.argsort(key, kind="stable")
    key, w = key[order], w[order]
    starts = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    w = np.minimum.reduceat(w, starts)
    key = key[starts]
    return key % n, key // n, w, n


def _csr(src, dst, vals, n):
    import scipy.sparse as sps

    return sps.csr_matrix((vals, (src, dst)), shape=(n, n))


def oracle_pagerank(src, dst, n, iters=PR_ITERS, damping=DAMPING):
    """float64 power iteration with models/dsl.pagerank's semantics:
    dangling mass spread evenly, fixed iteration count, r0 = 1/n."""
    AT = _csr(dst, src, np.ones(len(src)), n)  # AT[d, s] = 1 for s -> d
    deg = np.bincount(src, minlength=n).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    dang = deg == 0
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = (1.0 - damping) / n + damping * (AT @ (r * inv) + r[dang].sum() / n)
    return r


def oracle_bfs(src, dst, n, source):
    """Levels along directed edges (-1 = unreached), frontier by frontier."""
    csr = _csr(src, dst, np.ones(len(src), np.int8), n)
    level = np.full(n, -1, np.int64)
    level[source] = 0
    frontier = np.array([source])
    depth = 0
    while frontier.size:
        depth += 1
        nbr = np.unique(csr[frontier].indices)
        nbr = nbr[level[nbr] < 0]
        level[nbr] = depth
        frontier = nbr
    return level


def oracle_sssp(src, dst, w, n, source):
    from scipy.sparse.csgraph import dijkstra

    return dijkstra(_csr(src, dst, w.astype(np.float64), n), indices=source)


def oracle_cc(src, dst, n):
    """Each vertex's weak component, named by its smallest vertex id."""
    from scipy.sparse.csgraph import connected_components

    _, lab = connected_components(_csr(src, dst, np.ones(len(src), np.int8), n), directed=True, connection="weak")
    comp_min = np.full(lab.max() + 1, n, np.int64)
    np.minimum.at(comp_min, lab, np.arange(n))
    return comp_min[lab]


def check_pagerank(got, ref):
    l1 = float(np.abs(np.asarray(got, np.float64) - ref).sum())
    # f32 values over 50 iterations, GPU segment sums in unordered order
    assert l1 <= 1e-3, f"pagerank L1 distance {l1} > 1e-3"
    return l1


def check_levels(idx, vals, ref):
    got = np.full(len(ref), -1, np.int64)
    got[np.asarray(idx)] = np.asarray(vals)
    bad = int((got != ref).sum())
    assert bad == 0, f"bfs: {bad} levels differ"


def check_sssp(dense, ref):
    dense = np.asarray(dense, np.float64)
    reached = np.isfinite(ref)
    assert np.all(dense[~reached] >= _BIG * 0.99), "sssp: unreached vertex has a distance"
    # f32 sums of short paths
    np.testing.assert_allclose(dense[reached], ref[reached], rtol=1e-5, err_msg="sssp")


def check_cc(labels, ref):
    bad = int((np.asarray(labels).astype(np.int64) != ref).sum())
    assert bad == 0, f"cc: {bad} labels differ from the component minima"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _timed_runner(name, make, out_of):
    """Build a DSL runner, run it cold and warm; returns (runner, output)."""
    t0 = _now()
    runner = make()
    setup = _now() - t0
    t0 = _now()
    out = _block(out_of(runner()))
    first = _now() - t0
    t0 = _now()
    out = _block(out_of(runner()))
    warm = _now() - t0
    _log(
        f"  {name}: host setup {setup:.3f} s, compile {first - warm:.3f} s (first - warm), "
        f"first-run {first:.3f} s, warm-run {warm:.4f} s, peak_bytes_in_use {_peak_bytes()}"
    )
    return runner, out


def _matrices(src, dst, w, n):
    """The DSL matrices: AT[d, s] for an edge s -> d (pull orientation),
    unweighted (1.0) and weighted.  Matrices are sparse, vectors dense."""
    import graphblas_tpu as gb

    with gb.tx.config.set(dense_limit=n):
        AT = gb.Matrix.from_coo(dst, src, np.ones(len(src), np.float32), nrows=n, ncols=n)
        ATw = gb.Matrix.from_coo(dst, src, w.astype(np.float32), nrows=n, ncols=n)
    assert AT._sparse is not None and ATw._sparse is not None
    return AT, ATw


def phase_dsl(scale=22, edge_factor=16):
    """The main path: models/dsl.py runners under mxv_strategy="auto"."""
    import graphblas_tpu as gb
    from graphblas_tpu.models import dsl

    t0 = _now()
    src, dst, w, n = rmat_edges(scale, edge_factor)
    AT, ATw = _matrices(src, dst, w, n)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    _log(f"  graph: rmat scale {scale} ef {edge_factor}: n={n} edges={len(src)} "
         f"(deduplicated), source {source}; host build {_now() - t0:.3f} s")
    with gb.tx.config.set(dense_limit=n):
        assert gb.tx.config["mxv_strategy"] == "auto"

        t0 = _now()
        ref = oracle_pagerank(src, dst, n)
        _log(f"  oracle pagerank {_now() - t0:.3f} s")
        runner, out = _timed_runner(
            "pagerank", lambda: dsl.pagerank_runner(AT, max_iters=PR_ITERS), lambda v: v._values
        )
        l1 = check_pagerank(out, ref)
        _log(f"  pagerank ok: L1 {l1:.3e}, mode {runner.mode}/{runner.layout}")

        t0 = _now()
        ref = oracle_bfs(src, dst, n, source)
        _log(f"  oracle bfs {_now() - t0:.3f} s ({int(ref.max())} levels)")
        runner, _ = _timed_runner("bfs", lambda: dsl.bfs_level_runner(AT, source), lambda v: v._values)
        idx, vals = runner().to_coo()
        check_levels(idx, vals, ref)
        _log(f"  bfs ok: mode {runner.mode}")

        t0 = _now()
        ref = oracle_sssp(src, dst, w, n, source)
        _log(f"  oracle sssp {_now() - t0:.3f} s")
        runner, out = _timed_runner("sssp", lambda: dsl.sssp_runner(ATw, source), lambda v: v._values)
        check_sssp(out, ref)
        _log(f"  sssp ok: mode {runner.mode}, {int(runner.runner.last_iters)} rounds")

        t0 = _now()
        ref = oracle_cc(src, dst, n)
        _log(f"  oracle cc {_now() - t0:.3f} s")
        runner, out = _timed_runner("cc", lambda: dsl.connected_components_runner(AT), lambda v: v._values)
        check_cc(out, ref)
        _log(f"  cc ok: mode {runner.mode}, {int(runner.runner.last_iters)} super-rounds")


def phase_tc(scale=16, edge_factor=16):
    """Triangle count: C(L.S) << L.mxm(U, plus_pair), then reduce_scalar.

    Scale 16: the masked SpGEMM's host analysis (core/sparse.py, numpy)
    grows about 3x in time and memory per scale step (2.5, 3.6, 8.6 GB peak
    at scales 13-15); scale 18 ran out of a 96 GiB host."""
    import graphblas_tpu as gb
    from graphblas_tpu import dtypes, semiring

    src, dst, _, n = rmat_edges(scale, edge_factor)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    keep = lo != hi
    key = np.unique(hi[keep] * n + lo[keep])
    rows, cols = key // n, key % n  # strictly lower triangle of the symmetrised graph
    ref_L = _csr(rows, cols, np.ones(len(rows), np.int64), n)
    t0 = _now()
    ref = int((ref_L @ ref_L.T).multiply(ref_L).sum())
    _log(f"  oracle tc {_now() - t0:.3f} s")
    with gb.tx.config.set(dense_limit=n):
        t0 = _now()
        L = gb.Matrix.from_coo(rows, cols, np.ones(len(rows), np.float32), nrows=n, ncols=n)
        U = L.T.new()
        C = gb.Matrix(dtypes.INT64, n, n)
        setup = _now() - t0
        t0 = _now()
        C(L.S) << L.mxm(U, semiring.plus_pair[dtypes.FP32])
        count = int(C.reduce_scalar("plus").new().value)
        run = _now() - t0
    _log(f"  tc: scale {scale}, L nnz {len(rows)}, host setup {setup:.3f} s, "
         f"mxm + reduce {run:.3f} s (includes the host SpGEMM analysis), "
         f"peak_bytes_in_use {_peak_bytes()}")
    assert count == ref, f"tc: {count} triangles, oracle {ref}"
    _log(f"  tc ok: {count} triangles")


def phase_plan(scale=18, edge_factor=16):
    """The permutation-network engine: models/fast.py loops and one DSL
    PageRank under mxv_strategy="plan"."""
    import jax.numpy as jnp

    import graphblas_tpu as gb
    from graphblas_tpu.models import dsl
    from graphblas_tpu.models import fast as mf
    from graphblas_tpu.ops.fastspmv import build_spmv_plan

    src, dst, w, n = rmat_edges(scale, edge_factor)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    t0 = _now()
    plan = build_spmv_plan(src.astype(np.int32), dst.astype(np.int32), w, n=n)
    _log(f"  models/fast plan build {_now() - t0:.3f} s (e_pad {plan.e_pad})")
    outdeg = jnp.asarray(np.bincount(src, minlength=n).astype(np.int32))

    def timed(name, fn, per=1):
        out = _block(fn())
        t0 = _now()
        out = _block(fn())
        dt = _now() - t0
        _log(f"  {name}: warm {dt * 1e3 / per:.3f} ms" + (" per iteration" if per > 1 else ""))
        return out

    pr = timed("fast pagerank", lambda: mf.pagerank(plan, outdeg, n, max_iters=PR_ITERS, tol=0.0), PR_ITERS)
    check_pagerank(pr, oracle_pagerank(src, dst, n))
    lv = np.asarray(timed("fast bfs_level", lambda: mf.bfs_level(plan, source, n)))
    check_levels(np.flatnonzero(lv >= 0), lv[lv >= 0], oracle_bfs(src, dst, n, source))
    d = timed("fast sssp", lambda: mf.sssp(plan, source, n))
    check_sssp(d, oracle_sssp(src, dst, w, n, source))
    _log("  fast pagerank/bfs_level/sssp ok")

    AT, _ = _matrices(src, dst, w, n)
    with gb.tx.config.set(dense_limit=n, mxv_strategy="plan"):
        t0 = _now()
        runner = dsl.pagerank_runner(AT, max_iters=PR_ITERS)
        build = _now() - t0
        out = _block(runner()._values)
        t0 = _now()
        out = _block(runner()._values)
        warm = _now() - t0
    check_pagerank(out, oracle_pagerank(src, dst, n))
    _log(f"  dsl pagerank (plan): runner build incl. plan {build:.3f} s, warm "
         f"{warm * 1e3 / PR_ITERS:.3f} ms per iteration, layout {runner.layout}; ok")


def _time(fn, *args, reps=3):
    """(compile + first run s, best warm s) of a jitted call."""
    t0 = _now()
    out = _block(fn(*args))
    first = _now() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = _now()
        out = _block(fn(*args))
        best = min(best, _now() - t0)
    return out, first, best


def _np_segreduce(x, flags, op):
    """numpy reference (flags[0] set): "fill" gives each slot the value at
    its segment start; add/min/max give each slot its segment's total (add
    in float64)."""
    starts = np.flatnonzero(flags)
    seg = np.cumsum(flags) - 1
    if op == "fill":
        return x[starts][seg]
    if op == "add":
        return np.add.reduceat(x.astype(np.float64), starts)[seg]
    return {"min": np.minimum, "max": np.maximum}[op].reduceat(x, starts)[seg]


def phase_kernels(scan_log2=26, mxm_sizes=(2048, 4096), interpret=False):
    """The segmented fill/reduce at 2^scan_log2 slots and the tropical mxm
    kernel at each size, against plain references; ``interpret`` runs the
    Triton kernel in the Pallas interpreter (CPU tests)."""
    import jax
    import jax.numpy as jnp

    from graphblas_tpu import semiring
    from graphblas_tpu.core import dtypes
    from graphblas_tpu.ops import densemasked
    from graphblas_tpu.ops.segscan import (
        build_fill_tables,
        segment_ids,
        segmented_fill_static,
        segmented_reduce,
    )
    from graphblas_tpu.ops.tropical import tropical_mxm

    rng = np.random.default_rng(SEED)
    n = 1 << scan_log2
    # rmat-like segment lengths: ~16 slots on average
    flags = rng.random(n) < 1 / 16
    flags[0] = True
    seg = segment_ids(flags)
    nseg = int(seg[-1]) + 1
    seg_dev = jnp.asarray(seg)
    rand = rng.random(n, dtype=np.float32)
    ints = rng.integers(-1000, 1000, n).astype(np.float32)
    for op, data, exact in [
        ("add", ints, True),
        ("add", rand, False),
        ("min", rand, True),
        ("max", rand, True),
    ]:
        x = jnp.asarray(data)
        out, first, warm = _time(functools.partial(segmented_reduce, op=op, num_segments=nseg), x, seg_dev)
        t0 = _now()
        ref = _np_segreduce(data, flags, op)
        t_ref = _now() - t0
        got = np.asarray(out)
        if exact:
            assert np.array_equal(got, ref.astype(np.float32)), f"segmented {op} differs"
        else:
            # f32 sums of ~16 values in an unordered (atomic) order
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=f"segmented {op}")
        kind = "int-valued" if data is ints else "random"
        _log(f"  segmented {op} ({kind}) 2^{scan_log2}: compile+first {first:.3f} s, "
             f"warm {warm * 1e3:.3f} ms; numpy reference {t_ref:.3f} s; ok")
    src_idx, has_prior = build_fill_tables(flags)
    out, first, warm = _time(segmented_fill_static, jnp.asarray(rand), jnp.asarray(src_idx), jnp.asarray(has_prior))
    assert np.array_equal(np.asarray(out), _np_segreduce(rand, flags, "fill")), "static fill differs"
    _log(f"  static fill 2^{scan_log2}: compile+first {first:.3f} s, warm {warm * 1e3:.3f} ms; ok")

    for size in mxm_sizes:
        a = jnp.asarray(rng.random((size, size), dtype=np.float32) * 10)
        b = jnp.asarray(rng.random((size, size), dtype=np.float32) * 10)
        full = jnp.ones((size, size), bool)
        for add, mul in [("min", "plus"), ("max", "plus"), ("min", "max"), ("max", "min")]:
            sr = getattr(semiring, f"{add}_{mul}")[dtypes.FP32]
            kern = jax.jit(functools.partial(
                tropical_mxm, add_name=add, mul_name=mul, out_np_dtype=np.float32, interpret=interpret
            ))
            generic = functools.partial(
                densemasked.mxm, semiring=sr, out_dtype=dtypes.FP32, strategy="generic"
            )
            (kv, ks), k_first, k_warm = _time(kern, a, full, b, full)
            (gv, gs), g_first, g_warm = _time(generic, a, full, b, full)
            assert np.array_equal(np.asarray(ks), np.asarray(gs)), f"{add}_{mul} structure differs"
            assert np.array_equal(np.asarray(kv), np.asarray(gv)), f"{add}_{mul} values not bit-exact"
            _log(f"  tropical {add}_{mul} {size}^3: kernel compile+first {k_first:.3f} s, "
                 f"warm {k_warm * 1e3:.3f} ms; generic compile+first {g_first:.3f} s, "
                 f"warm {g_warm * 1e3:.3f} ms; bit-exact")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as ex:
        return f"nvidia-smi failed: {ex}"


def main():
    _log(f"nvidia-smi: {_nvidia_smi()}")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {dev.platform}", file=sys.stderr)
        return 1
    import graphblas_tpu as gb

    gb._init(automatic=True)
    _log(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
         f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
         f"compile cache {jax.config.jax_compilation_cache_dir}")
    t_all = _now()
    for name, phase in [("kernels", phase_kernels), ("dsl", phase_dsl), ("tc", phase_tc), ("plan", phase_plan)]:
        t0 = _now()
        _log(f"phase {name}:")
        phase()
        _log(f"phase {name} done in {_now() - t0:.1f} s")
    _log(f"all phases done in {_now() - t_all:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
