"""Multi-chip execution: SUMMA mxm, the sharded SpMV engine, and DSL ops
inside an engaged mesh Context.

Runs on real multi-chip hardware unchanged; for a laptop/CI demo it forces
an 8-virtual-device CPU mesh (the same harness the test suite and the
driver's dryrun use):

    python examples/08_multichip.py
"""

import os

if "XLA_FLAGS" not in os.environ:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("GRAPHBLAS_TPU_PLATFORM", "cpu")

import numpy as np

import graphblas_tpu as gb  # noqa: E402
from graphblas_tpu import Matrix, Vector, dtypes, parallel, semiring, tx  # noqa: E402

import jax  # noqa: E402

print(f"devices: {len(jax.devices())} x {jax.devices()[0].platform}")

rng = np.random.default_rng(0)
n, e = 512, 4096
src = rng.integers(0, n, e)
dst = rng.integers(0, n, e)
w = rng.random(e).astype(np.float32)

# -- 1. DSL ops route through the mesh inside an engaged Context ----------
with tx.config.set(dense_limit=0, mxv_strategy="plan"):
    A = Matrix.from_coo(src, dst, w, dtypes.FP32, nrows=n, ncols=n, dup_op="plus", name="A")
    x = Vector.from_coo(np.arange(n), rng.random(n).astype(np.float32), dtypes.FP32, size=n)
    single = A.mxv(x, semiring.plus_times).new()
    with parallel.Context(shape=(2, 4)) as ctx:
        print(f"engaged {ctx!r}")
        sharded = A.mxv(x, semiring.plus_times).new()  # multi-chip engine
    assert sharded.isclose(single, rel_tol=1e-5)
    print("DSL mxv inside Context matches single-device ... OK")

# -- 2. the sharded permutation-network engine directly -------------------
splan = parallel.build_sharded_spmv_plan(src, dst, w, n=n)
y = parallel.sharded_spmv(splan, np.ones(n, np.float32), add="plus", mul="times")
ref = np.zeros(n, np.float64)
np.add.at(ref, dst, w.astype(np.float64))
np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5)
print(f"sharded SpMV over {splan.ndev} devices ... OK")

# -- 3. whole PageRank loop (one jitted program, one collective per iter) --
r, iters = parallel.sharded_pagerank(splan)
print(f"sharded PageRank converged in {int(iters)} iterations; sum={float(np.sum(np.asarray(r))):.6f}")

# -- 4. SUMMA semiring mxm over the 2D mesh -------------------------------
from graphblas_tpu.core.operator import get_typed_op  # noqa: E402
from graphblas_tpu.parallel import summa_mxm  # noqa: E402

B = Matrix.from_dense(rng.random((16, 24)).astype(np.float32))
C = Matrix.from_dense(rng.random((24, 16)).astype(np.float32))
sr = get_typed_op(semiring.plus_times, dtypes.FP32, dtypes.FP32, kind="semiring")
ctx = parallel.Context(shape=(2, 4))
cv, cs = summa_mxm(B, C, sr, dtypes.FP32, ctx.mesh)
np.testing.assert_allclose(
    np.asarray(cv), np.asarray(B.to_dense(0.0)) @ np.asarray(C.to_dense(0.0)), rtol=1e-4
)
print("SUMMA plus_times mxm over 2x4 mesh ... OK")
print("multichip example OK")
