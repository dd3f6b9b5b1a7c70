"""graphblas_tpu: a GraphBLAS on JAX.

Same user-facing model as python-graphblas (reference:
/root/reference/graphblas/__init__.py): sparse ``Matrix``/``Vector``/``Scalar``
over arbitrary semirings with masks, accumulators and descriptors, driven by a
delayed-expression DSL whose signature move is::

    C(mask.S, accum=binary.plus, replace=True) << A.mxm(B, semiring.min_plus)

The compute engine, however, is JAX/XLA/Pallas on the GPU instead of
SuiteSparse:GraphBLAS over cffi.  Collections are stored as static-shape
device arrays (dense-masked blocks and blocked-sparse formats), every
operation family lowers to jit-compiled kernels, and multi-chip execution
shards collections over a ``jax.sharding.Mesh``.

Like the reference, heavy submodules load lazily on first attribute access
(reference: graphblas/__init__.py:41-96).
"""

import importlib as _importlib
import os as _os

from . import exceptions  # noqa: F401
from .core.config import Config as _Config

__version__ = "0.1.0"


class replace:
    """Singleton to indicate ``replace=True`` when used in an updater call.

    Reference: graphblas/__init__.py:5-19.
    """

    def __new__(cls):
        return cls

    def __reduce__(self):
        return "replace"

    def __repr__(self):
        return "graphblas_tpu.replace"


# Library-level config (reference: graphblas/__init__.py:22-36 + graphblas.yaml)
config = _Config(
    "graphblas_tpu",
    defaults={
        # When True, expression objects auto-compute when used as values
        "autocompute": True,
        # When True, *.numpy operator namespaces alias numpy-named ops to builtins
        "mapnumpy": True,
        # When True, 64-bit dtypes are enabled in JAX at first use.  GraphBLAS
        # default dtypes are FP64/INT64, so this defaults to True; the plan
        # engine's channels are 32-bit regardless.
        "enable_x64": True,
    },
)

_SPECIAL_ATTRS = {
    "Matrix",
    "Vector",
    "Scalar",
    "Recorder",
    "MAX_SIZE",
    "core",
    "dtypes",
    "unary",
    "binary",
    "monoid",
    "semiring",
    "indexunary",
    "indexbinary",
    "select",
    "op",
    "agg",
    "io",
    "viz",
    "tx",
    "ss",
    "models",
    "parallel",
    "backend",
    "compile",
    "loop",
    "until",
    "loop_runner",
    "until_runner",
}

_initialized = False
backend = None


is_blocking = False


def init(backend_name="jax", blocking=None):
    """Initialize the engine (API parity with ``gb.init``, reference:
    graphblas/__init__.py:107-117).

    Error-timing spec (reference: exceptions.py:33-66; SURVEY hard part #3):
    API errors — dimension/type/domain/index — ALWAYS raise at the offending
    statement in both modes (the Python layer validates eagerly).  Device
    execution is asynchronous; ``blocking=True`` additionally synchronizes
    after every mutating statement (device faults surface at the statement),
    while the default non-blocking mode surfaces them at ``wait()`` or the
    first value read.  Re-initializing with a different mode raises, like
    the reference (graphblas/__init__.py:124-137).
    """
    _init(backend_name, blocking)


def _init(backend_name="jax", blocking=None, automatic=False):
    global _initialized, backend, is_blocking
    if _initialized:
        if backend_name not in {"jax", backend}:
            raise exceptions.GraphblasException(
                f"graphblas_tpu is already initialized with backend {backend!r}; "
                f"init() with {backend_name!r} is not allowed"
            )
        if blocking is not None and bool(blocking) != is_blocking and not automatic:
            raise exceptions.GraphblasException(
                f"graphblas_tpu is already initialized with blocking={is_blocking}; "
                "it cannot be re-initialized with a different mode"
            )
        return
    if blocking is not None:
        is_blocking = bool(blocking)
    import os

    import jax

    if config.get("enable_x64"):
        jax.config.update("jax_enable_x64", True)
    # Test hook: the test suite forces "cpu" to run the engine on a virtual
    # multi-device CPU mesh.
    platform = os.environ.get("GRAPHBLAS_TPU_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    _configure_compile_cache(jax)
    backend = "jax"
    _initialized = True


# Persistent XLA compilation cache when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory inside the checkout (listed in .gitignore).  The path is
# part of the cache key, so it never varies between runs.
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _configure_compile_cache(jax):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset does
    the package point the cache at ``COMPILE_CACHE_DIR``."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    _os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def __getattr__(name):
    """Lazy-load the main classes and namespaces on first access
    (reference: graphblas/__init__.py:65-96)."""
    if name in _SPECIAL_ATTRS:
        _init(automatic=True)
        return _load(name)
    if name == "replace":
        return replace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(globals().keys() | _SPECIAL_ATTRS)


_CLASS_HOMES = {
    "Matrix": "graphblas_tpu.core.matrix",
    "Vector": "graphblas_tpu.core.vector",
    "Scalar": "graphblas_tpu.core.scalar",
    "Recorder": "graphblas_tpu.core.recorder",
    # loop capture: whole Python loops of DSL statements -> ONE XLA program
    "compile": "graphblas_tpu.core.compiler",
    "loop": "graphblas_tpu.core.compiler",
    "until": "graphblas_tpu.core.compiler",
    "loop_runner": "graphblas_tpu.core.compiler",
    "until_runner": "graphblas_tpu.core.compiler",
}


def _load(name):
    if name in _CLASS_HOMES:
        module = _importlib.import_module(_CLASS_HOMES[name])
        value = getattr(module, name)
        globals()[name] = value
        return value
    if name == "MAX_SIZE":
        # Largest dimension the index space supports (int64 indices).
        value = 2**62
        globals()[name] = value
        return value
    if name == "ss":  # alias of the tx extension namespace for drop-in parity
        module = _importlib.import_module("graphblas_tpu.tx")
        globals()["ss"] = module
        return module
    if name == "backend":
        return backend
    module = _importlib.import_module(f"graphblas_tpu.{name}")
    globals()[name] = module
    return module
