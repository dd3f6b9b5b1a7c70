"""PageRank in pure DSL ops over the sparse (analyzed COO) Matrix format.

The same GraphBLAS statements scale from toy graphs to RMAT scale-19: the
sparse container routes ``contrib.vxm(A, plus_first)`` through the
permutation-network SpMV engine (reference workload: Pagerank Demo
notebook).  Set GRAPHBLAS_PR_SCALE to run bigger graphs on a GPU.
"""

import os
import time

import numpy as np

import graphblas_tpu as gb
from graphblas_tpu import Matrix, Vector, binary, dtypes, semiring, tx, unary

scale = int(os.environ.get("GRAPHBLAS_PR_SCALE", "10"))
ef = 16
damping = 0.85
iters = int(os.environ.get("GRAPHBLAS_PR_ITERS", "20"))

rng = np.random.default_rng(5)
n = 1 << scale
e = n * ef
src = rng.integers(0, n, e)
dst = rng.integers(0, n, e)

# big graphs pick the sparse format automatically (tx.config['dense_limit'])
fp32 = scale >= 14  # large scale: f32 engages the permutation-network plan
dt = dtypes.FP32 if fp32 else dtypes.FP64
A = Matrix.from_coo(src, dst, 1.0, dt, nrows=n, ncols=n, dup_op=binary.first)
print(f"A: {A.nvals} edges, format={A.tx.format}")

outdeg = A.reduce_rowwise(binary.plus).new(dt, name="outdeg")
inv_deg = outdeg.apply(unary.minv).new(name="inv_deg")
total_nodes = n

rank = Vector.from_dense(np.full(n, 1.0 / n, dt.np_type), name="rank")
teleport = (1.0 - damping) / n

t0 = time.perf_counter()
for i in range(iters):
    contrib = rank.ewise_mult(inv_deg, binary.times).new(name="contrib")
    pulled = contrib.vxm(A, semiring.plus_first).new(name="pulled")
    # dangling mass: rank held by nodes with no out-edges
    dangling = float(rank.reduce(binary.plus).new().value) - float(
        contrib.ewise_mult(outdeg, binary.times).reduce(binary.plus).new().value
    )
    rank = pulled.apply(binary.times, right=damping).apply(
        binary.plus, right=teleport + damping * dangling / n
    ).new(name="rank")
elapsed = time.perf_counter() - t0

total = float(rank.reduce(binary.plus).new().value)
print(f"{iters} DSL iterations in {elapsed:.3f}s ({elapsed / iters * 1e3:.2f} ms/iter)")
print(f"sum of ranks: {total:.6f}")
assert abs(total - 1.0) < 1e-3
print("Sparse PageRank OK")
