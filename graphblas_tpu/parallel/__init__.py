"""Multi-chip distribution: mesh contexts and sharded collections.

The reference has no distributed layer (SURVEY.md §2.2); its resource-scoping
hook is ``gb.ss.Context`` (thread/GPU control, reference:
core/ss/context.py:19-151).  Here the analogue scopes a ``jax.sharding.Mesh``:
collections shard as 2D blocks over the mesh, semiring mxm runs SUMMA-style
over mesh collectives (see ``summa``), and masks/vectors co-shard.
"""

import threading

from .fastspmv import (  # noqa: F401
    build_sharded_spmv_plan,
    sharded_bfs_level,
    sharded_pagerank,
    sharded_spmv,
    sharded_spmv_masked,
    sharded_sssp,
)
from .summa import (  # noqa: F401
    sharded_spmv_step,
    summa_mxm,
    summa_mxm_arrays,
    summa_mxv,
    summa_mxv_arrays,
)

_threadlocal = threading.local()


class Context:
    """Scope a device mesh for sharded execution.

    Analogue of ``gb.ss.Context`` (reference: core/ss/context.py): engage /
    disengage with a thread-local stack, usable as a context manager.
    """

    def __init__(self, mesh=None, *, shape=None, axis_names=("i", "j"), devices=None):
        import numpy as np

        import jax

        if mesh is None:
            if devices is None:
                devices = jax.devices()
            n = len(devices)
            if shape is None:
                # squarest 2-D factorization
                pi = int(n**0.5)
                while n % pi:
                    pi -= 1
                shape = (pi, n // pi)
            mesh = jax.sharding.Mesh(np.asarray(devices).reshape(shape), axis_names)
        self.mesh = mesh
        self.axis_names = mesh.axis_names

    def engage(self):
        stack = getattr(_threadlocal, "stack", None)
        if stack is None:
            stack = _threadlocal.stack = []
        stack.append(self)
        return self

    def disengage(self):
        stack = getattr(_threadlocal, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()

    def __enter__(self):
        return self.engage()

    def __exit__(self, *exc):
        self.disengage()
        return False

    def __repr__(self):
        return f"parallel.Context(mesh={tuple(self.mesh.shape.items())})"


def current_context():
    stack = getattr(_threadlocal, "stack", [])
    return stack[-1] if stack else None


def shard_matrix(A, context=None, *, spec=None):
    """Shard a Matrix's device arrays as 2D blocks over the mesh (in place).

    The reference's user-level block decomposition hooks are
    ``Matrix.ss.split`` / ``gb.ss.concat`` (core/ss/matrix.py:280,362); here
    the split is a sharding annotation — XLA moves the blocks.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    ctx = context or current_context()
    if ctx is None:
        raise ValueError("No mesh Context engaged; pass context= or use `with Context():`")
    if getattr(A, "_sparse", None) is not None:
        # never densify a sparse operand onto the mesh (a GAP-scale graph is
        # ~2^39 dense elements); sparse collections distribute through their
        # own paths, which an engaged Context already routes automatically
        raise TypeError(
            "shard_matrix expects a dense-format Matrix; sparse matrices "
            "distribute without densifying: masked mxm partitions by "
            "mask-row blocks (parallel.spgemm, used automatically by "
            "C(M) << A.mxm(B) inside an engaged Context) and SpMV uses "
            "per-device stacked plans (parallel.build_sharded_spmv_plan)"
        )
    spec = P(*(spec or ctx.axis_names))
    sharding = NamedSharding(ctx.mesh, spec)
    A._values = jax.device_put(A._values, sharding)
    A._struct = jax.device_put(A._struct, sharding)
    return A


def shard_vector(v, context=None, *, axis=None):
    """Shard a Vector over one mesh axis (default: last)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    ctx = context or current_context()
    if ctx is None:
        raise ValueError("No mesh Context engaged; pass context= or use `with Context():`")
    axis = axis or ctx.axis_names[-1]
    sharding = NamedSharding(ctx.mesh, P(axis))
    v._values = jax.device_put(v._values, sharding)
    v._struct = jax.device_put(v._struct, sharding)
    return v


def replicate(x, context=None):
    """Replicate a collection on every device of the mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    ctx = context or current_context()
    sharding = NamedSharding(ctx.mesh, P())
    x._values = jax.device_put(x._values, sharding)
    x._struct = jax.device_put(x._struct, sharding)
    return x
