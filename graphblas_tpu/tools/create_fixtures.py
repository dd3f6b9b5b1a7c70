"""Regenerate the committed serialization fixtures in tests/fixtures/.

Reference pattern: scripts/create_pickle.py generating
graphblas/tests/pickle*.pkl.  Run on CPU:

    JAX_PLATFORMS=cpu python -m graphblas_tpu.tools.create_fixtures
"""

import os
import pickle

import numpy as np


def main():
    import graphblas_tpu as gb
    import graphblas_tpu.dtypes  # materialize the namespace for register_new
    from graphblas_tpu.core import dtypes as dtm
    from graphblas_tpu.core.matrix import Matrix
    from graphblas_tpu.core.vector import Vector

    out = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "tests", "fixtures")
    os.makedirs(out, exist_ok=True)
    A = Matrix.from_coo([0, 1, 3], [2, 0, 3], [1.5, -2.0, 7.25], dtm.FP64, nrows=4, ncols=4)
    open(f"{out}/matrix_fp64.gbtx", "wb").write(A.tx.serialize(compression=None))
    B = Matrix.from_coo([0, 2], [1, 2], [7, -9], dtm.INT32, nrows=3, ncols=3)
    open(f"{out}/matrix_int32_zstd.gbtx", "wb").write(B.tx.serialize(compression="zstd"))
    C = Matrix.from_coo([0, 1 << 30], [5, 3], [1.0, 2.0], dtm.FP32, nrows=1 << 32, ncols=1 << 32)
    open(f"{out}/matrix_sparse_fp32.gbtx", "wb").write(C.tx.serialize(compression=None))
    v = Vector.from_coo([1, 4, 6], [True, False, True], dtm.BOOL, size=8)
    open(f"{out}/vector_bool.gbtx", "wb").write(v.tx.serialize(compression=None))
    Point = dtm.register_new("FixturePoint", [("x", "<f8"), ("y", "<i4")])
    pv = np.array([(1.0, 2), (3.0, 4)], dtype=Point.np_type)
    M = Matrix.from_coo([0, 1], [1, 0], pv, Point, nrows=2, ncols=2)
    blob = pickle.dumps(
        {
            "matrix": A,
            "vector": v,
            "udt_matrix": M,
            "op": gb.binary.plus,
            "semiring": gb.semiring.min_plus,
            "dtype": Point,
        },
        protocol=4,
    )
    open(f"{out}/pickle1.pkl", "wb").write(blob)
    print("fixtures written:", sorted(os.listdir(out)))


if __name__ == "__main__":
    main()
