"""``graphblas_tpu.tx``: engine extension namespace.

Analogue of ``graphblas.ss`` (reference: /root/reference/graphblas/ss/_core.py):
free functions (diag, concat), the global engine config, and an About mapping.
``graphblas_tpu.ss`` aliases this module for drop-in familiarity.
"""

import numpy as np

from ..core.config import Config
from ..core import dtypes as _dt

# Global engine config (analogue of gb.ss.config, reference: ss/_core.py:108-257)
config = Config(
    "graphblas_tpu.tx",
    defaults={
        # mxm lowering strategy: "auto" picks matmul forms when available
        "mxm_strategy": "auto",
        # generic-mxm k-chunk size
        "mxm_chunk": 128,
        # default device platform preference ("gpu" > "cpu")
        "platform": "auto",
        # print engine dispatch diagnostics (analogue of SuiteSparse burble)
        "burble": False,
        # matrices above this many cells store as analyzed-COO sparse
        # (analogue of SuiteSparse sparsity_control / hyper_switch)
        "dense_limit": 1 << 24,
        # hard guard: densifying a sparse matrix past this many cells raises
        "densify_limit": 1 << 26,
        # sparse mxv/vxm lowering: auto | plan (permutation network) | generic
        "mxv_strategy": "auto",
        # unmasked sparse mxm: max intermediate products the host Gustavson
        # expand-join may materialize (masked SpGEMM has no such limit)
        "spgemm_flop_limit": 1 << 28,
        # accepted for compatibility; XLA owns threading
        "nthreads": 0,
        "chunk": 0,
    },
)


class _About(dict):
    def __repr__(self):
        return "\n".join(f"{k}: {v}" for k, v in self.items())


def _make_about():
    import jax

    import graphblas_tpu

    return _About(
        {
            "library_name": "graphblas_tpu JAX engine",
            "library_version": graphblas_tpu.__version__,
            "jax_version": jax.__version__,
            "platform": jax.default_backend(),
            "device_count": jax.device_count(),
        }
    )


def __getattr__(name):
    if name == "about":
        return _make_about()
    raise AttributeError(f"module 'graphblas_tpu.tx' has no attribute {name!r}")


def diag(x, k=0, dtype=None, *, name=None):
    """Vector -> diagonal Matrix, or Matrix -> diagonal Vector
    (reference: gb.ss.diag, ss/_core.py:24-72)."""
    from ..core.matrix import Matrix
    from ..core.vector import Vector

    if isinstance(x, Vector):
        result = x.diag(k)
        if dtype is not None:
            result = result.dup(dtype)
        if name:
            result.name = name
        return result
    if isinstance(x, Matrix):
        result = x.diag(k, dtype)
        if name:
            result.name = name
        return result
    raise TypeError(f"diag requires a Matrix or Vector; got {type(x)}")


def concat(tiles, dtype=None, *, name=None):
    """Concatenate a 2-D grid of Matrix tiles (or a list of Vectors)
    (reference: gb.ss.concat, ss/_core.py:73-106)."""
    import jax.numpy as jnp

    from ..core.matrix import Matrix
    from ..core.vector import Vector

    if not isinstance(tiles, (list, tuple)) or not tiles:
        raise TypeError("tiles argument must be a non-empty list")
    first = tiles[0]
    if isinstance(first, (list, tuple)):
        # grid of matrices
        rows_v = []
        rows_s = []
        for row in tiles:
            row = [t._get_value() if hasattr(t, "_get_value") and not isinstance(t, Matrix) else t for t in row]
            rows_v.append(jnp.concatenate([t._values for t in row], axis=1))
            rows_s.append(jnp.concatenate([t._struct for t in row], axis=1))
        v = jnp.concatenate(rows_v, axis=0)
        s = jnp.concatenate(rows_s, axis=0)
        out_dtype = dtype if dtype is not None else tiles[0][0].dtype
        return Matrix._from_arrays(v.astype(_dt.lookup_dtype(out_dtype).np_type), s, out_dtype, name=name)
    # list of vectors
    v = jnp.concatenate([t._values for t in tiles])
    s = jnp.concatenate([t._struct for t in tiles])
    out_dtype = dtype if dtype is not None else tiles[0].dtype
    return Vector._from_arrays(v.astype(_dt.lookup_dtype(out_dtype).np_type), s, out_dtype, name=name)


class burble:
    """Context manager toggling engine dispatch diagnostics
    (analogue of SuiteSparse burble, reference: graphblas/ss/__init__.py:1)."""

    def __init__(self):
        self._saved = None

    @property
    def is_enabled(self):
        return config["burble"]

    def __enter__(self):
        self._saved = config["burble"]
        config["burble"] = True
        return self

    def __exit__(self, *exc):
        config["burble"] = self._saved
        return False


# -- raw-buffer imports (reference: zero-copy Matrix.ss.import_* /
#    Vector.ss.import_*, core/ss/matrix.py:537-3649) -------------------------


def import_csr(*, indptr, col_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_csr(indptr, col_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_csc(*, indptr, row_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_csc(indptr, row_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_coo(*, rows, cols, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_coo(rows, cols, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_fullr(*, values, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_dense(values, dtype=dtype, name=name)


def import_bitmapr(*, bitmap, values, dtype=None, name=None, **opts):
    import jax.numpy as jnp
    import numpy as np

    from ..core.matrix import Matrix

    values = np.asarray(values)
    bitmap = np.asarray(bitmap, bool)
    m = Matrix.from_dense(values, dtype=dtype, name=name)
    m._struct = jnp.asarray(bitmap)
    m._values, m._struct = __import__("graphblas_tpu.ops.densemasked", fromlist=["canonical"]).canonical(
        m._values, m._struct
    )
    return m


def import_fullc(*, values, dtype=None, name=None, **opts):
    """Column-major full import (reference: core/ss/matrix.py import_fullc):
    ``values`` is ncols-major — transpose back to row-major storage."""
    import numpy as np

    from ..core.matrix import Matrix

    values = np.asarray(values)
    if values.ndim != 2:
        raise ValueError("fullc import requires a 2-D values array (column-major sense)")
    return Matrix.from_dense(np.ascontiguousarray(values), dtype=dtype, name=name)


def import_bitmapc(*, bitmap, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Column-major bitmap import (reference: core/ss/matrix.py
    import_bitmapc): flat/2-D arrays are in column-major (Fortran) order."""
    import numpy as np

    bitmap = np.asarray(bitmap)
    values = np.asarray(values)
    if bitmap.ndim == 1:
        # flat buffers are column-major: element (i, j) at j*nrows + i
        if nrows is None or ncols is None:
            raise ValueError("flat bitmapc import requires nrows and ncols")
        bitmap = bitmap.reshape(ncols, nrows).T
        values = values.reshape(ncols, nrows).T
    return import_bitmapr(bitmap=np.ascontiguousarray(bitmap), values=np.ascontiguousarray(values), dtype=dtype, name=name)


def import_coor(*, rows, cols, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Row-sorted COO import (reference: import_coor — same data, the sort
    order is a hint the dense engine does not need)."""
    return import_coo(rows=rows, cols=cols, values=values, nrows=nrows, ncols=ncols, dtype=dtype, name=name)


def import_cooc(*, rows, cols, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Column-sorted COO import (reference: import_cooc)."""
    return import_coo(rows=rows, cols=cols, values=values, nrows=nrows, ncols=ncols, dtype=dtype, name=name)


def import_any(**blob):
    """Dispatch an exported blob (or keyword buffers with ``format=``) back
    to the right importer (reference: Matrix.ss.import_any,
    core/ss/matrix.py:537+)."""
    fmt = blob.pop("format", "coo").lower()
    importers = {
        "coo": import_coo,
        "coor": import_coor,
        "cooc": import_cooc,
        "csr": import_csr,
        "csc": import_csc,
        "hypercsr": import_hypercsr,
        "hypercsc": import_hypercsc,
        "bitmapr": import_bitmapr,
        "bitmapc": import_bitmapc,
        "fullr": import_fullr,
        "fullc": import_fullc,
    }
    if fmt == "densemasked":
        import jax.numpy as jnp
        import numpy as np

        from ..core.matrix import Matrix
        from ..ops.densemasked import canonical

        m = Matrix.from_dense(np.asarray(blob["values"]), dtype=blob.get("dtype"))
        m._struct = jnp.asarray(np.asarray(blob["struct"], bool))
        m._values, m._struct = canonical(m._values, m._struct)
        return m
    if fmt not in importers:
        raise ValueError(f"Invalid format for import_any: {fmt}")
    import inspect

    fn = importers[fmt]
    allowed = set(inspect.signature(fn).parameters)
    return fn(**{k: v for k, v in blob.items() if k in allowed or "opts" in allowed})


def import_hypercsr(*, rows, indptr, col_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Hypersparse-CSR import (reference: core/ss/matrix.py import_hypercsr)."""
    from ..core.matrix import Matrix

    return Matrix.from_dcsr(rows, indptr, col_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_hypercsc(*, cols, indptr, row_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Hypersparse-CSC import (reference: core/ss/matrix.py import_hypercsc)."""
    from ..core.matrix import Matrix

    return Matrix.from_dcsc(cols, indptr, row_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_sparse_vector(*, indices, values, size=None, dtype=None, name=None, **opts):
    from ..core.vector import Vector

    return Vector.from_coo(indices, values, dtype, size=size, name=name)


def deserialize(data):
    """Inverse of Matrix.tx.serialize / Vector.tx.serialize (kind-dispatching)."""
    import pickle as _pickle

    from . import _binary

    raw = _binary.decompress(data)
    if raw[:4] == _binary.MAGIC:
        kind = _binary.unpack(raw)[0]["kind"]
    else:
        kind = _pickle.loads(raw)["kind"]  # legacy pickle payloads
    if kind == "Matrix":
        from .matrix import deserialize_matrix

        return deserialize_matrix(data)
    from .vector import deserialize_vector

    return deserialize_vector(data)
