"""Benchmark driver: GAP-style PageRank/BFS/SSSP GTEPS on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
Baseline (BASELINE.md): the reference publishes no numbers; vs_baseline =
value / 1.0 GTEPS.  ``detail`` names the device (platform, device_kind,
count) and the card (nvidia-smi name and power limit).

Pipeline: an RMAT graph, its permutation-network SpMV plan built in this
process (graphblas_tpu/ops/fastspmv.py), then the compiled algorithms, each
timed with ``block_until_ready`` after a warm-up run.  Any failure fails the
run (non-zero exit, no JSON line), and so does a first device that is not a
GPU.

Env overrides: GRAPHBLAS_BENCH_SCALE (default 19), GRAPHBLAS_BENCH_EF (16).
"""

import json
import os
import subprocess
import time

import numpy as np


def _card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or "not available"
    except (OSError, subprocess.SubprocessError):
        return "not available"


def _measure(fn, m=1, reps=3):
    """Median wall time of ``fn()`` (ended by block_until_ready) per work
    unit, after one compile+warm-up call."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] / m


def main():
    import jax
    import jax.numpy as jnp

    import graphblas_tpu

    # the model path is all 32-bit; x64 would force 64-bit index promotion
    graphblas_tpu.config.set(enable_x64=False)
    graphblas_tpu._init(automatic=True)
    from graphblas_tpu import Matrix, semiring
    from graphblas_tpu import tx as txmod
    from graphblas_tpu.core import dtypes as dtmod
    from graphblas_tpu.core.operator import get_typed_op
    from graphblas_tpu.core.sparse import sparse_spgemm_analyze, sparse_spgemm_execute
    from graphblas_tpu.models import dsl
    from graphblas_tpu.models import fast as mf
    from graphblas_tpu.models.graph import rmat
    from graphblas_tpu.ops.fastspmv import build_spmv_plan
    from graphblas_tpu.ops.tropical import tropical_mxm_filled

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's first device is {dev.platform}")
    scale = int(os.environ.get("GRAPHBLAS_BENCH_SCALE", "19"))
    ef = int(os.environ.get("GRAPHBLAS_BENCH_EF", "16"))
    g = rmat(scale, ef, seed=5, weighted=True)
    valid = np.asarray(g.valid)
    src = np.asarray(g.src)[valid]
    dst = np.asarray(g.dst)[valid]
    w = np.asarray(g.weights)[valid]
    n, e = g.n, len(src)
    del g
    t0 = time.perf_counter()
    plan = build_spmv_plan(src, dst, w, n=n)
    plan_build_s = time.perf_counter() - t0
    outdeg_np = np.bincount(src, minlength=n)
    outdeg = jnp.asarray(outdeg_np.astype(np.int32))
    sources = np.argsort(outdeg_np)[::-1][:4].tolist()

    # ---- PageRank (primary: GTEPS per plus_times mxv iteration) ----------
    iters = 50
    pr_time = _measure(lambda: mf.pagerank(plan, outdeg, n, max_iters=iters, tol=0.0), iters)

    # ---- BFS / SSSP (several sources, one device queue) ------------------
    def run_all(fn):
        return [fn(plan, s, n) for s in sources]

    bfs_time = _measure(lambda: run_all(mf.bfs_level), len(sources))
    nlevels = int(np.asarray(mf.bfs_level(plan, sources[0], n)).max())
    sssp_time = _measure(lambda: run_all(mf.sssp), len(sources))

    # ---- masked semiring SpGEMM (triangle-counting shape) -----------------
    # C(L.S) = L plus_pair L^T over the lower triangle of a clustered graph
    # (cliques + random edges: real intersection work)
    from graphblas_tpu import binary

    rng_l = np.random.default_rng(7)
    ns, csize = 1 << 16, 64
    base = np.arange(ns) - (np.arange(ns) % csize)
    rs_ = np.concatenate([np.arange(ns)] * (csize - 1) + [rng_l.integers(0, ns, ns * 2)])
    cs_ = np.concatenate(
        [base + (np.arange(ns) + d) % csize for d in range(1, csize)] + [rng_l.integers(0, ns, ns * 2)]
    )
    lo, hi = np.minimum(rs_, cs_), np.maximum(rs_, cs_)
    keep = lo != hi
    with txmod.config.set(dense_limit=0):
        L = Matrix.from_coo(hi[keep], lo[keep], np.float32(1.0), dtmod.FP32, nrows=ns, ncols=ns, dup_op=binary.first)
        U = L.T.new()
    sr = get_typed_op(semiring.plus_pair, dtmod.FP32, dtmod.FP32, kind="semiring")
    lsp, usp = L._sparse, U._sparse
    task_plan = sparse_spgemm_analyze(lsp, usp, lsp.rows, lsp.cols, bricks=True, reduce_net=True)
    _, _, flops_dev = sparse_spgemm_execute(task_plan, sr, dtmod.FP32, keep_on_device=True)
    spgemm_time = _measure(lambda: sparse_spgemm_execute(task_plan, sr, dtmod.FP32, keep_on_device=True)[0])
    spgemm_gf = int(flops_dev) / spgemm_time / 1e9

    # ---- dense tropical (min_plus) mxm ------------------------------------
    mt = 2048
    rng_t = np.random.default_rng(3)
    a = jnp.asarray(rng_t.random((mt, mt), np.float32))
    b = jnp.asarray(rng_t.random((mt, mt), np.float32))
    trop_time = _measure(lambda: tropical_mxm_filled(a, b, "min", "plus"))

    # ---- DSL-expressed algorithms (user path, mxv_strategy="auto") --------
    with txmod.config.set(dense_limit=n):
        AT = Matrix.from_coo(dst, src, np.ones(e, np.float32), dtmod.FP32, nrows=n, ncols=n, dup_op=binary.plus)
        pr_run = dsl.pagerank_runner(AT, max_iters=iters)
        dsl_pr = _measure(lambda: pr_run()._values, iters)
        bfs_run = dsl.bfs_level_runner(AT, sources[0])
        dsl_bfs = _measure(lambda: bfs_run()._values)

    pr_gteps = e / pr_time / 1e9
    result = {
        "metric": "PageRank GTEPS/iter (RMAT scale=%d ef=%d, permutation-network SpMV)" % (scale, ef),
        "value": round(pr_gteps, 4),
        "unit": "GTEPS",
        "vs_baseline": round(pr_gteps / 1.0, 4),
        "detail": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": _card(),
            "nodes": n,
            "edges": e,
            "plan_build_s": round(plan_build_s, 3),
            "pagerank_iter_ms": round(pr_time * 1e3, 3),
            "bfs_ms": round(bfs_time * 1e3, 3),
            "bfs_gteps": round(e / bfs_time / 1e9, 4),
            "bfs_levels": nlevels,
            "sssp_ms": round(sssp_time * 1e3, 3),
            "sssp_gteps": round(e / sssp_time / 1e9, 4),
            "masked_spgemm_gflops": round(spgemm_gf, 4),
            "masked_spgemm_mask_nnz": int(lsp.nvals),
            "tropical_mxm_tops": round(2 * mt**3 / trop_time / 1e12, 4),
            "dsl_pagerank_iter_ms": round(dsl_pr * 1e3, 3),
            "dsl_bfs_ms": round(dsl_bfs * 1e3, 3),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
