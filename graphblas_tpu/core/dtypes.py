"""DataType registry on top of numpy/jax dtypes.

Mirrors the behavior of the reference registry
(/root/reference/graphblas/core/dtypes.py:18-667): 13 builtin types plus an
index type, ``lookup_dtype`` resolution from many spellings, ``unify`` via
numpy promotion, and user-defined types (UDTs) registered from numpy
structured dtypes.  There is no C-typedef plumbing (``_jit_c_info``) — the JAX
engine stores UDTs as struct-of-arrays pytrees instead.
"""

import warnings

import numpy as np

from .. import exceptions as _exc

_registry = {}  # many-spellings -> DataType


class DataType:
    """A registered element type.

    Attributes
    ----------
    name : canonical python-graphblas name (e.g. ``"FP64"``)
    gb_name : GraphBLAS C API name (e.g. ``"GrB_FP64"``) or None for UDTs
    np_type : the numpy dtype backing device storage
    """

    __slots__ = "name", "gb_name", "np_type", "_anonymous"

    def __init__(self, name, gb_name, np_type, *, anonymous=False):
        self.name = name
        self.gb_name = gb_name
        self.np_type = np.dtype(np_type)
        self._anonymous = anonymous

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        if type(other) is DataType:
            return self.name == other.name and self.np_type == other.np_type
        try:
            other = lookup_dtype(other)
        except ValueError:
            raise TypeError(f"Invalid or unknown datatype: {other!r}") from None
        return self.name == other.name and self.np_type == other.np_type

    def __hash__(self):
        return hash((self.name, self.np_type))

    def __reduce__(self):
        if self._is_udt:
            return (_string_to_dtype, (_dtype_to_string(self.np_type),))
        return self.name

    @property
    def _is_udt(self):
        return self.gb_name is None

    @property
    def _is_anonymous(self):
        return self._anonymous

    # Convenience predicates (used by the operator type tables)
    @property
    def _is_bool(self):
        return self.np_type == np.bool_

    @property
    def _is_int(self):
        return self.np_type.kind in "iu"

    @property
    def _is_signed_int(self):
        return self.np_type.kind == "i"

    @property
    def _is_unsigned_int(self):
        return self.np_type.kind == "u"

    @property
    def _is_float(self):
        return self.np_type.kind == "f"

    @property
    def _is_complex(self):
        return self.np_type.kind == "c"


def register_new(name, dtype_spec):
    """Register a user-defined type under ``graphblas_tpu.dtypes.<name>``.

    Reference: core/dtypes.py:165-194.
    """
    if not name.isidentifier():
        raise ValueError(f"`name` argument must be a valid Python identifier; got: {name!r}")
    if _MODULE is None:  # lazily materialize the gb.dtypes namespace
        import importlib

        importlib.import_module("graphblas_tpu.dtypes")
    if name in _registry or hasattr(_MODULE, name):
        raise ValueError(f"{name!r} name for dtype is unavailable")
    rv = register_anonymous(dtype_spec, name)
    _registry[name] = rv
    setattr(_MODULE, name, rv)
    return rv


def register_anonymous(dtype_spec, name=None):
    """Register a UDT without a module-level name (reference: core/dtypes.py:195-326)."""
    try:
        dtype = np.dtype(dtype_spec)
    except TypeError:
        if isinstance(dtype_spec, dict):
            # Allow e.g. {"x": int, "y": float}
            dtype = np.dtype([(key, lookup_dtype(val).np_type) for key, val in dtype_spec.items()])
        else:
            raise
    if dtype in _registry:
        rv = _registry[dtype]
        if name is not None and rv.name != name:
            raise ValueError(f"dtype {dtype} is already registered as {rv.name}")
        return rv
    if dtype.hasobject:
        raise ValueError("dtype must not allow Python objects")
    rv = DataType(name if name is not None else f"UDT{dtype}", None, dtype, anonymous=name is None)
    _registry[dtype] = rv
    _registry[dtype.str] = rv
    return rv


def _default_name(np_type):
    return {
        np.dtype(np.bool_): "BOOL",
        np.dtype(np.int8): "INT8",
        np.dtype(np.int16): "INT16",
        np.dtype(np.int32): "INT32",
        np.dtype(np.int64): "INT64",
        np.dtype(np.uint8): "UINT8",
        np.dtype(np.uint16): "UINT16",
        np.dtype(np.uint32): "UINT32",
        np.dtype(np.uint64): "UINT64",
        np.dtype(np.float32): "FP32",
        np.dtype(np.float64): "FP64",
        np.dtype(np.complex64): "FC32",
        np.dtype(np.complex128): "FC64",
    }.get(np.dtype(np_type))


BOOL = DataType("BOOL", "GrB_BOOL", np.bool_)
INT8 = DataType("INT8", "GrB_INT8", np.int8)
INT16 = DataType("INT16", "GrB_INT16", np.int16)
INT32 = DataType("INT32", "GrB_INT32", np.int32)
INT64 = DataType("INT64", "GrB_INT64", np.int64)
UINT8 = DataType("UINT8", "GrB_UINT8", np.uint8)
UINT16 = DataType("UINT16", "GrB_UINT16", np.uint16)
UINT32 = DataType("UINT32", "GrB_UINT32", np.uint32)
UINT64 = DataType("UINT64", "GrB_UINT64", np.uint64)
FP32 = DataType("FP32", "GrB_FP32", np.float32)
FP64 = DataType("FP64", "GrB_FP64", np.float64)
# Complex types are a SuiteSparse extension (GxB); JAX supports complex64/128
# on the CPU and the GPU — kept for API parity.
FC32 = DataType("FC32", "GxB_FC32", np.complex64)
FC64 = DataType("FC64", "GxB_FC64", np.complex128)
# Index type used for positional ops and index extraction
# (reference: core/dtypes.py:444-457 `_INDEX`)
_INDEX = DataType("UINT64", "GrB_Index", np.uint64)

# bfloat16 is an extension type (no reference counterpart): the tensor
# cores' native input.  Registered under the ``tx`` (extension) spelling.
try:  # pragma: no cover - availability depends on ml_dtypes
    import ml_dtypes as _ml_dtypes

    BF16 = DataType("BF16", "GxB_BF16", np.dtype(_ml_dtypes.bfloat16))
except ImportError:  # pragma: no cover
    _ml_dtypes = None
    BF16 = None

_BUILTINS = [BOOL, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64, FP32, FP64, FC32, FC64]

for _dt in _BUILTINS + ([BF16] if BF16 is not None else []):
    _registry[_dt.name] = _dt
    _registry[_dt.name.lower()] = _dt
    _registry[_dt.gb_name] = _dt
    _registry[_dt.np_type] = _dt
    _registry[_dt.np_type.name] = _dt
    _registry[_dt.np_type.str] = _dt
    _registry[_dt.np_type.type] = _dt

# Common aliases (reference: core/dtypes.py:459-524)
for _alias, _dt in [
    (bool, BOOL),
    (int, INT64),
    (float, FP64),
    (complex, FC64),
    ("bool_", BOOL),
    ("int", INT64),
    ("float", FP64),
    ("complex", FC64),
    ("byte", INT8),
    ("ubyte", UINT8),
    ("intc", INT32),
    ("uintc", UINT32),
    ("longlong", INT64),
    ("ulonglong", UINT64),
    ("single", FP32),
    ("double", FP64),
    ("csingle", FC32),
    ("cdouble", FC64),
    ("half", FP32),  # fp16 maps up to FP32 for storage
]:
    _registry.setdefault(_alias, _dt)


def lookup_dtype(key, value=None):
    """Resolve many spellings of a dtype to a registered DataType.

    Unknown numpy dtypes (e.g. structured dtypes) are auto-registered as
    anonymous UDTs, matching reference core/dtypes.py:527-549.
    """
    if key is None:
        if value is not None:
            return lookup_dtype(np.asarray(value).dtype)
        raise TypeError("Bad dtype: None")
    if type(key) is DataType:
        return key
    try:
        hashable = True
        if key in _registry:
            return _registry[key]
    except TypeError:
        hashable = False
    if isinstance(key, str):
        upper = key.upper()
        if upper in _registry:
            return _registry[upper]
    try:
        np_type = np.dtype(key)
    except Exception:
        np_type = None
    if np_type is not None:
        if np_type in _registry:
            rv = _registry[np_type]
            if hashable:
                _registry[key] = rv
            return rv
        # auto-register unknown (e.g. structured) dtype
        return register_anonymous(np_type)
    raise ValueError(f"Unknown dtype: {key!r}")


def unify(type1, type2, *, is_left_scalar=False, is_right_scalar=False):
    """Numpy-style promotion of two DataTypes (reference: core/dtypes.py:552-585)."""
    if type1 is type2 or type1 == type2:
        return type1
    if type1._is_udt or type2._is_udt:
        if type1._is_udt and type2._is_udt and type1.np_type == type2.np_type:
            return type1
        raise _exc.DomainMismatch(f"Cannot unify UDTs {type1.name} and {type2.name}")
    return _promote(type1, type2)


def _promote(type1, type2):
    return lookup_dtype(np.promote_types(type1.np_type, type2.np_type))


# --- 64-bit execution policy (docs/types.md) ---------------------------------
#
# The reference's default dtype is FP64 (SuiteSparse computes in C doubles).
# The contract: FP64/INT64/UINT64 are fully supported *collection* dtypes
# everywhere; with ``enable_x64=False`` the engine computes and stores values
# at 32-bit width, and host materialization (``to_coo``/``to_dense``) returns
# the declared 64-bit numpy dtype.  ``executes_64bit`` reports the active
# policy; ``default_float``/``default_int`` are the policy-adaptive choices
# model code uses instead of hard-coding FP64/INT64 (a device ``astype`` to
# a 64-bit dtype under a 32-bit policy warns and truncates).


def executes_64bit():
    """True when device arrays carry 64-bit dtypes at full width."""
    import jax

    return bool(jax.config.jax_enable_x64)


def default_float():
    """FP64 under the 64-bit policy, FP32 otherwise."""
    return FP64 if executes_64bit() else FP32


def default_int():
    """INT64 under the 64-bit policy, INT32 otherwise."""
    return INT64 if executes_64bit() else INT32


def executed_np(np_type):
    """The numpy dtype DEVICE arrays actually carry for ``np_type`` under the
    64-bit contract: 64-bit float/int dtypes narrow to their 32-bit
    counterparts under the 32-bit policy (astype at the declared width would
    warn and truncate to the same thing)."""
    np_type = np.dtype(np_type)
    if not executes_64bit() and np_type.itemsize == 8 and np_type.kind in "fiu":
        return np.dtype(np_type.kind + "4")
    return np_type


def _supports_complex():
    return True


# --- UDT string serialization (reference: core/dtypes.py:588-667) ------------


def _dtype_to_string(np_type):
    """Convert a numpy dtype to a string eval-able back to the same dtype."""
    if np_type in _registry and not _registry[np_type]._is_udt:
        return repr(_registry[np_type].name)
    s = str(np_type)
    try:
        if np.dtype(eval(s, {}, {})) == np_type:  # noqa: S307
            return s
    except Exception:
        pass
    return repr(s)


def _string_to_dtype(s):
    """Inverse of _dtype_to_string."""
    try:
        return lookup_dtype(s)
    except ValueError:
        pass
    try:
        obj = eval(s, {}, {})  # noqa: S307
    except Exception as exc:
        raise ValueError(f"Unknown dtype: {s!r}") from exc
    try:
        return lookup_dtype(obj)
    except ValueError:
        return lookup_dtype(np.dtype(obj))


_MODULE = None  # set by graphblas_tpu.dtypes package at import
