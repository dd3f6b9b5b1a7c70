"""Sparse ("analyzed COO") Matrix storage + its kernel paths.

The reference scales past dense storage with CSR/CSC/hypersparse formats
inside SuiteSparse (reference: /root/reference/graphblas/core/ss/matrix.py:537+,
index space to 2^60 per graphblas/__init__.py:210-213).  The analogue here
is this container: canonical row-major COO on the host (int64 indices —
dimensions way past device memory are representable) and device caches per
sort order, so the DSL's ``A.mxv(v)`` / ``v.vxm(A)`` run O(E) gather+segment
SpMV instead of dense-masked kernels; under ``mxv_strategy="plan"`` a
lazily-built permutation-network ``SpmvPlan`` per direction runs the
network engine (ops/fastspmv) instead.

Dispatch contract: a ``Matrix`` whose ``_sparse`` is set has NO dense
``_values``/``_struct``; touching them densifies if the dense size is under
``tx.config["dense_limit"]`` and raises otherwise.  The op layer
(collection_ops) routes mxv/vxm/reduce/apply/select through the functions
here before any densify can trigger.
"""

import os

import numpy as np

from .. import exceptions as _exc

_INT32_MAX = np.iinfo(np.int32).max

# numpy ufuncs for host-side dup combination (subset of dup_op names)
_NP_COMBINE = {
    "plus": np.add,
    "times": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
    "lor": np.logical_or,
    "land": np.logical_and,
    "bor": np.bitwise_or,
    "band": np.bitwise_and,
}

# monoids with a direct jax.ops.segment_* lowering
_SEGMENT_OPS = {"plus", "min", "max", "times", "lor", "land", "any"}


def _dense_limit():
    """Storage-format preference: above this many cells, prefer sparse."""
    from ..tx import config as _txconfig

    return int(_txconfig.get("dense_limit", 1 << 24))


def _densify_limit():
    """Hard guard: densifying past this many cells raises OutOfMemory."""
    from ..tx import config as _txconfig

    return int(_txconfig.get("densify_limit", 1 << 26))


def _index_np():
    """Device index dtype: int64 under the 64-bit policy, int32 otherwise
    (the 64-bit execution contract, docs/types.md — avoids per-op
    truncation warnings from device astype(int64) with x64 off)."""
    from . import dtypes as _dtm

    return np.int64 if _dtm.executes_64bit() else np.int32


def _mxv_strategy():
    from ..tx import config as _txconfig

    return _txconfig.get("mxv_strategy", "auto")


class SparseMatrixData:
    """Canonical sorted-dedup'd COO + device/plan caches for one Matrix."""

    __slots__ = (
        "rows",
        "cols",
        "vals",
        "nrows",
        "ncols",
        "_dev",
        "_plans",
        "_sharded_plans",
        "_col_order",
        "_stats",
    )

    def __init__(self, rows, cols, vals, nrows, ncols):
        self.rows = rows  # np.int64, row-major sorted
        self.cols = cols  # np.int64
        self.vals = vals  # np array of the Matrix dtype
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self._dev = {}
        self._plans = {}
        self._sharded_plans = {}
        self._col_order = None
        self._stats = {}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_arrays(cls, rows, cols, vals, nrows, ncols, dup_op=None, *, sorted_dedup=False):
        """Canonicalize (row-major sort + dup combine) host COO arrays."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        cols = np.asarray(cols, np.int64).reshape(-1)
        vals = np.asarray(vals).reshape(-1)
        if not sorted_dedup and rows.size:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
            dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if dup.any():
                rows, cols, vals = _combine_dups(rows, cols, vals, dup, dup_op)
        return cls(rows, cols, vals, nrows, ncols)

    @property
    def nvals(self):
        return int(self.rows.size)

    def copy(self, vals=None):
        return SparseMatrixData(
            self.rows, self.cols, self.vals if vals is None else vals, self.nrows, self.ncols
        )

    def transposed(self):
        """Swap row/col roles (re-canonicalized; indices shared, not copied)."""
        order = self.col_order()
        return SparseMatrixData(
            self.cols[order], self.rows[order], self.vals[order], self.ncols, self.nrows
        )

    def col_order(self):
        """Permutation to column-major order (lazily computed and cached)."""
        if self._col_order is None:
            self._col_order = np.lexsort((self.rows, self.cols))
        return self._col_order

    # ------------------------------------------------------------------
    # device caches
    # ------------------------------------------------------------------

    def _idx_dtype(self):
        return np.int32 if max(self.nrows, self.ncols) <= _INT32_MAX else np.int64

    def device(self, key):
        """Device array cache: rows/cols/vals in row ('r') or col ('c') order."""
        import jax
        import jax.numpy as jnp

        if key not in self._dev:
            # a first touch may happen inside a gb.compile/loop trace; the
            # cache must hold CONCRETE device arrays, never tracers
            with jax.ensure_compile_time_eval():
                return self._device_build(key, jnp)
        return self._dev[key]

    def _device_build(self, key, jnp):
        if key not in self._dev:
            idt = self._idx_dtype()
            if key == "rows_r":
                self._dev[key] = jnp.asarray(self.rows.astype(idt))
            elif key == "cols_r":
                self._dev[key] = jnp.asarray(self.cols.astype(idt))
            elif key == "vals_r":
                self._dev[key] = jnp.asarray(self.vals)
            elif key == "rows_c":
                self._dev[key] = jnp.asarray(self.rows[self.col_order()].astype(idt))
            elif key == "cols_c":
                self._dev[key] = jnp.asarray(self.cols[self.col_order()].astype(idt))
            elif key == "vals_c":
                self._dev[key] = jnp.asarray(self.vals[self.col_order()])
            else:  # pragma: no cover
                raise KeyError(key)
        return self._dev[key]

    def _vals_absmax(self):
        """max |value| (cached; 64-bit plan-channel range gate)."""
        if "absmax" not in self._stats:
            v = self.vals
            self._stats["absmax"] = float(np.max(np.abs(v.astype(np.float64)))) if v.size else 0.0
        return self._stats["absmax"]

    def _indeg_max(self, direction):
        """max segment length over the dst axis (cached)."""
        key = f"degmax_{direction}"
        if key not in self._stats:
            dst = self.rows if direction == "pull" else self.cols
            if dst.size == 0:
                self._stats[key] = 0
            else:
                _, cnt = np.unique(dst, return_counts=True)
                self._stats[key] = int(cnt.max())
        return self._stats[key]

    # ------------------------------------------------------------------
    # permutation-network plans
    # ------------------------------------------------------------------

    def sharded_plan(self, direction, mesh):
        """Multi-chip SpmvPlan stack for an engaged mesh Context
        (parallel/fastspmv.py): edges partition by destination range, one
        per-device plan each; cached per (direction, mesh devices)."""
        key = (direction, tuple(int(d.id) for d in mesh.devices.reshape(-1)))
        if key not in self._sharded_plans:
            from ..parallel.fastspmv import build_sharded_spmv_plan

            n = max(self.nrows, self.ncols)
            src, dst = (self.cols, self.rows) if direction == "pull" else (self.rows, self.cols)
            w = None
            if self.vals is not None and not np.issubdtype(self.vals.dtype, np.bool_):
                w = self.vals.astype(np.float32)
            self._sharded_plans[key] = build_sharded_spmv_plan(src, dst, w, n=n, mesh=mesh)
        return self._sharded_plans[key]

    def plan(self, direction, loop=False):
        """SpmvPlan for 'pull' (dst=rows, src=cols) or 'push' (dst=cols).

        Built once per direction (the pattern-analysis step — the analogue of
        SuiteSparse picking Gustavson/hash/dot per matrix); cached in memory
        and, when GRAPHBLAS_TPU_PLAN_CACHE points at a directory, on disk.

        ``loop=True`` requests the loop-capable variant (total + loop
        network — build_spmv_plan total=True): compiled DSL loops need it for
        the edge-layout lowering (core/looplayout.py).  It serves every
        n-space dispatch identically, so it REPLACES the plain plan in the
        cache — at most one analysis per (pattern, direction) per process.
        """
        cached = self._plans.get(direction)
        if cached is None or (loop and not (cached.total and cached.loop_plan is not None)):
            import jax

            from ..ops import fastspmv as _fs

            with jax.ensure_compile_time_eval():
                return self._plan_build(direction, _fs, loop=loop)
        return cached

    def _plan_build(self, direction, _fs, loop=False):
        cached = self._plans.get(direction)
        needs_build = cached is None or (
            loop and not (cached.total and cached.loop_plan is not None)
        )
        if needs_build:
            n = max(self.nrows, self.ncols)
            src, dst = (self.cols, self.rows) if direction == "pull" else (self.rows, self.cols)
            w = _channel_weights(self.vals)
            cache_dir = os.environ.get("GRAPHBLAS_TPU_PLAN_CACHE")
            path = None
            if cache_dir:
                import hashlib

                # PATTERN-keyed (symbolic/numeric split): the networks are
                # pure pattern analysis, so one cached plan serves every
                # same-pattern matrix; the weight channel is re-derived at
                # load.  Weightless (bool) matrices key separately.
                h = hashlib.blake2b(digest_size=16)
                h.update(np.int64([self.nrows, self.ncols, self.nvals]).tobytes())
                h.update(self.rows.tobytes())
                h.update(self.cols.tobytes())
                if w is None:
                    h.update(b"noW")
                variant = "loopT_" if loop else ""
                path = os.path.join(
                    cache_dir, f"gbtpu_plan3_{variant}{direction}_{h.hexdigest()}.npz"
                )
                if os.path.exists(path):
                    try:
                        self._plans[direction] = _fs.load_spmv_plan(path, w=w)
                        return self._plans[direction]
                    except Exception:
                        pass  # unreadable/stale cache entry: rebuild below
            # eager DSL dispatch never touches the loop-layout network;
            # skipping it saves ~1/4 of the analysis.  Compiled loops request
            # loop=True (total + loop network) for the edge-layout lowering.
            plan = _fs.build_spmv_plan(src, dst, w, n=n, loop_net=loop, total=loop)
            if path is not None:
                os.makedirs(cache_dir, exist_ok=True)
                _fs.save_spmv_plan(plan, path)
            self._plans[direction] = plan
        return self._plans[direction]

    # ------------------------------------------------------------------
    # densify (guarded)
    # ------------------------------------------------------------------

    def densify(self, np_dtype, *, limit=None):
        """(values, struct) dense jnp arrays; raises past the dense limit."""
        import jax.numpy as jnp

        limit = _densify_limit() if limit is None else limit
        cells = self.nrows * self.ncols
        if cells > limit:
            raise _exc.OutOfMemory(
                f"operation requires densifying a {self.nrows}x{self.ncols} sparse Matrix "
                f"({cells} cells > tx.config['densify_limit']={limit}); use sparse-supported "
                "ops (mxv/vxm/reduce/apply/select/transpose/extract) or raise the limit"
            )
        dv = np.zeros((self.nrows, self.ncols), self.vals.dtype)
        ds = np.zeros((self.nrows, self.ncols), bool)
        dv[self.rows, self.cols] = self.vals
        ds[self.rows, self.cols] = True
        from .utils import device_asarray

        if self.vals.dtype.names is not None:
            # UDT: struct-of-arrays device layout (one leaf per field)
            return (
                {f: jnp.asarray(dv[f]) for f in self.vals.dtype.names},
                jnp.asarray(ds),
            )
        return device_asarray(dv), jnp.asarray(ds)


def _combine_dups(rows, cols, vals, dup, dup_op):
    """Combine adjacent duplicate (row, col) runs in sorted COO arrays."""
    if dup_op is None:
        raise ValueError("Duplicate indices found; must provide dup_op to combine them")
    starts = np.flatnonzero(np.concatenate([[True], ~dup]))
    name = getattr(dup_op, "name", None) or str(dup_op)
    base = name.split("[")[0]
    if vals.dtype.names is not None and base not in {"first", "second", "any"}:
        raise TypeError(
            "UDT duplicate combination on sparse storage supports only "
            "first/second/any dup_op"
        )
    np_fn = _NP_COMBINE.get(base)
    out_rows, out_cols = rows[starts], cols[starts]
    if np_fn is not None:
        out_vals = np_fn.reduceat(vals, starts)
    elif base == "first":
        out_vals = vals[starts]
    elif base in {"second", "any"}:
        lasts = np.concatenate([starts[1:], [len(rows)]]) - 1
        out_vals = vals[lasts]
    else:
        # generic typed op: combine each dup group through the op's jax fn
        from .operator import get_typed_op
        from . import dtypes as _dt

        op_t = get_typed_op(dup_op, _dt.lookup_dtype(vals.dtype), kind="binary")
        ends = np.concatenate([starts[1:], [len(rows)]])
        out_vals = vals[starts].copy()
        for gi, (s, e) in enumerate(zip(starts, ends)):
            acc = vals[s]
            for k in range(s + 1, e):
                acc = np.asarray(op_t.fn(acc, vals[k]))
            out_vals[gi] = acc
    return out_rows, out_cols, out_vals


# ---------------------------------------------------------------------------
# segmented reduction over sorted segment ids (the sparse monoid core)
# ---------------------------------------------------------------------------


def _segment_reduce(contrib, valid, seg_ids, num_segments, monoid_t):
    """Dense (y, ys) from per-edge contributions grouped by sorted seg_ids.

    Standard monoids lower to jax.ops.segment_* (one scatter); any other
    monoid runs a segmented associative_scan with the monoid's jax fn —
    exact for every registered/user monoid.
    """
    import jax
    import jax.numpy as jnp

    name = monoid_t.parent.name
    ident = monoid_t.identity
    out_dt = contrib.dtype
    if contrib.size == 0:
        iv = jnp.zeros((), out_dt) if ident is None else jnp.asarray(ident, out_dt)
        return jnp.full((num_segments,), iv), jnp.zeros((num_segments,), bool)

    from ..ops.densemasked import _host_concrete

    if _host_concrete(valid, seg_ids):
        # structure hoisting (core/compiler.py): structure output stays a
        # host-side trace-time constant when the inputs are
        ys = np.bincount(
            np.asarray(seg_ids), weights=np.asarray(valid), minlength=num_segments
        )[:num_segments] > 0
    else:
        ys = jax.ops.segment_max(valid.astype(jnp.int32), seg_ids, num_segments=num_segments) > 0

    if name in _SEGMENT_OPS:
        if name == "plus":
            eff = jnp.where(valid, contrib, jnp.zeros((), out_dt))
            y = jax.ops.segment_sum(eff, seg_ids, num_segments=num_segments)
        elif name == "times":
            eff = jnp.where(valid, contrib, jnp.ones((), out_dt))
            y = jax.ops.segment_prod(eff, seg_ids, num_segments=num_segments)
        elif name in {"min", "land"}:
            big = _extreme(out_dt, "max")
            eff = jnp.where(valid, contrib, big)
            y = jax.ops.segment_min(eff, seg_ids, num_segments=num_segments)
        else:  # max, lor, any
            small = _extreme(out_dt, "min")
            eff = jnp.where(valid, contrib, small)
            y = jax.ops.segment_max(eff, seg_ids, num_segments=num_segments)
        if out_dt == jnp.bool_:
            y = y.astype(bool)
    else:
        import jax.lax as lax

        iv = jnp.asarray(ident, out_dt)
        eff = jnp.where(valid, contrib, iv)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), seg_ids[1:] != seg_ids[:-1]]
        )
        fn = monoid_t.fn

        def comb(a, b):
            af, av = a
            bf, bv = b
            return af | bf, jnp.where(bf, bv, fn(av, bv).astype(av.dtype))

        _, scanned = lax.associative_scan(comb, (first, eff))
        is_end = jnp.concatenate([seg_ids[1:] != seg_ids[:-1], jnp.ones((1,), bool)])
        idx = jnp.where(is_end, seg_ids, num_segments).astype(seg_ids.dtype)
        y = jnp.full((num_segments,), iv).at[idx].set(scanned, mode="drop")
    y = jnp.where(ys, y, jnp.zeros((), out_dt))
    return y, ys


def _extreme(dtype, which):
    import jax.numpy as jnp

    if dtype == jnp.bool_:
        return jnp.asarray(which == "max", bool)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.asarray(np.inf if which == "max" else -np.inf, dtype)
    info = np.iinfo(np.dtype(dtype))
    return jnp.asarray(info.max if which == "max" else info.min, dtype)


# ---------------------------------------------------------------------------
# semiring mxv / vxm
# ---------------------------------------------------------------------------

_PLAN_ADDS = {"plus", "min", "max", "any"}
_PLAN_MULS = {"times", "plus", "first", "second", "pair", "oneb"}


def sparse_mxv(sp, pull, a_first, xv, xs, sr, out_dtype):
    """Semiring y = A (.) x over one direction of a sparse matrix.

    pull: dst=rows/src=cols (GrB_mxv on A); push: dst=cols (vxm / mxv on A.T).
    a_first: the stored matrix is the multiply's FIRST argument (mxv) or the
    second (vxm).  Returns dense (values, struct) over the dst axis.
    Reference semantics: GrB_mxv core/matrix.py:2203, GrB_vxm core/vector.py:1309.
    """
    import jax.numpy as jnp

    out_np = np.dtype(out_dtype.np_type)
    n_out = sp.nrows if pull else sp.ncols
    mul = sr.binaryop
    addm = sr.monoid
    add_name = addm.parent.name
    pos = mul.positional
    strategy = _mxv_strategy()

    from . import looplayout as _ll

    probe = _ll.probing()
    if probe is not None:
        # compiled-loop probe trace: record the dispatch so the compiler can
        # decide edge-layout eligibility (core/looplayout.py)
        probe.record(sp, pull, a_first, sr)
    lctx = _ll.active()
    if lctx is not None and getattr(xv, "ndim", 0) == 1 and xv.shape[0] == lctx.e_pad:
        # edge-layout body trace: the input is loop state in the edge space —
        # 2 networks/SpMV through the composed loop network (vs 3 in n-space)
        return _ll.edge_mxv(lctx, sp, pull, a_first, xv, xs, sr, out_dtype)

    plan_mul = _plan_mul_name(mul, a_first, pos)
    if _plan_allowed(sp, strategy, add_name, plan_mul, out_np, pos, xv):
        channel = _plan_channel(sp, strategy, add_name, plan_mul, out_np, pos, xv)
        yv, ys = _plan_mxv(sp, pull, xv, xs, add_name, plan_mul, pos, out_np, channel)
        if yv.shape[0] != n_out:
            yv, ys = yv[:n_out], ys[:n_out]
        return yv.astype(out_np), ys

    # generic gather + segment path: exact for every semiring/dtype
    if pull:
        dst = sp.device("rows_r")
        src = sp.device("cols_r")
        avals = sp.device("vals_r")
    else:
        dst = sp.device("cols_c")
        src = sp.device("rows_c")
        avals = sp.device("vals_c")
    xg = xv[src]
    from ..ops.densemasked import _host_concrete as _hc

    # keep the structure gather host-side under traces (structure hoisting)
    valid = np.asarray(xs)[np.asarray(src)] if _hc(xs, src) else xs[src]
    if pos is not None:
        which, delta = pos
        role = _positional_role(which, a_first)
        if role == "src":
            contrib = src.astype(_index_np()) + delta
        elif role == "dst":
            contrib = dst.astype(_index_np()) + delta
        else:
            contrib = jnp.zeros(src.shape, _index_np()) + delta
        contrib = contrib.astype(out_np)
    else:
        a_c = avals.astype(np.dtype((mul.type_ if a_first else mul.type2).np_type))
        x_c = xg.astype(np.dtype((mul.type2 if a_first else mul.type_).np_type))
        contrib = (mul.fn(a_c, x_c) if a_first else mul.fn(x_c, a_c)).astype(out_np)
    monoid_t = addm if addm.type_.np_type == out_np else _retype_monoid(addm, out_dtype)
    return _segment_reduce(contrib, valid, dst, n_out, monoid_t)


def _retype_monoid(monoid_t, out_dtype):
    from .operator import get_typed_op

    return get_typed_op(monoid_t.parent, out_dtype, kind="monoid")


def _positional_role(which, a_first):
    """Where a positional multiply's index lives for a matrix-vector product.

    Reference tables (core/operator/base.py:33-87): in C=A*B terms firsti=i,
    firstj=k, secondi=k, secondj=j.  For mxv (a_first) the vector is B (k,1):
    j==0; for vxm the vector is A (1,k): i==0.
    """
    base = which
    if base in {"firstj", "secondi"}:
        return "src"
    if base == "firsti":
        return "dst" if a_first else "zero"
    # secondj
    return "zero" if a_first else "dst"


def _plan_mul_name(mul, a_first, pos):
    """Map the GraphBLAS multiply onto a fastspmv channel, or None."""
    if pos is not None:
        which, _ = pos
        return "secondi" if _positional_role(which, a_first) == "src" else None
    name = mul.parent.name
    if name not in _PLAN_MULS:
        return None
    if name in {"times", "plus"}:
        return name
    if name in {"pair", "oneb"}:
        return "pair"
    # first/second: fastspmv's "first" channel is x, "second" is the weights
    if name == "first":
        return "second" if a_first else "first"
    return "first" if a_first else "second"


def _channel_weights(vals):
    """Edge-weight channel array for the plan engine: f32 for floats, int32
    for integer/bool dtypes (astype sign/zero-extends narrow ints and wraps
    64-bit — 64-bit use is range-gated in _plan_channel)."""
    if vals is None:
        return None
    if np.issubdtype(vals.dtype, np.floating):
        return vals.astype(np.float32)
    return vals.astype(np.int32)


def _plan_channel(sp, strategy, add_name, plan_mul, out_np, pos, xv):
    """The plan-engine payload dtype (np.float32 | np.int32) for this
    dispatch, or None to use the generic path.

    Exactness rules (GraphBLAS integer ops wrap at the output width — C
    semantics, reference: SuiteSparse builtin typed ops):
    - FP32: f32 channel (native).
    - INT8/16/32, UINT8/16, BOOL: int32 channel, bit-exact — modular
      arithmetic commutes with truncation, and min/max compare contributions
      wrapped to the output width before the scan (segscan wrap=).
    - UINT32: int32 channel for plus/any (modular / representation-agnostic);
      min/max would compare sign-flipped — generic path.
    - INT64/UINT64: int32 channel only when a conservative range bound on
      every intermediate (matrix values x concrete vector values x max
      in-degree for plus) fits int32 — else generic.  Exactness is never
      silently lost.
    - FP64: generic (the engine would round to f32).
    """
    if strategy == "generic" or plan_mul is None or add_name not in _PLAN_ADDS:
        return None
    if pos is not None:
        # src-id channel is int32: exact below 2^31
        if max(sp.nrows, sp.ncols) >= (1 << 31):
            return None
        return np.float32
    kind = out_np.kind
    if out_np == np.float32:
        return np.float32
    if kind == "b" or (kind in "iu" and out_np.itemsize <= 2) or out_np == np.int32:
        return np.int32
    if out_np == np.uint32:
        return np.int32 if add_name in ("plus", "any") else None
    if kind in "iu" and out_np.itemsize == 8:
        import jax as _jax

        if isinstance(xv, _jax.core.Tracer):
            return None  # cannot range-check abstract values
        try:
            xmax = float(np.max(np.abs(np.asarray(xv)))) if np.asarray(xv).size else 0.0
        except TypeError:
            return None
        mmax = sp._vals_absmax()
        if plan_mul == "times":
            bound = mmax * xmax
        elif plan_mul == "plus":
            bound = mmax + xmax
        elif plan_mul == "first":
            bound = xmax
        elif plan_mul == "second":
            bound = mmax
        else:  # pair
            bound = 1.0
        if add_name == "plus":
            bound *= max(sp._indeg_max("pull"), 1)
        return np.int32 if bound < float(1 << 31) else None
    return None


def uses_plan_engine(strategy):
    """The one rule for choosing the permutation-network plan engine over
    the gather+segment path, shared by eager mxv/vxm (``_plan_allowed``) and
    the compiled-loop edge layout (core/compiler.py).  Only the explicit
    ``mxv_strategy="plan"`` takes the plan engine: "auto" stays on
    gather+segment and never builds a network on the host."""
    return strategy == "plan"


def _plan_allowed(sp, strategy, add_name, plan_mul, out_np, pos, xv):
    return uses_plan_engine(strategy) and (
        _plan_channel(sp, strategy, add_name, plan_mul, out_np, pos, xv) is not None
    )


def _plan_mxv(sp, pull, xv, xs, add_name, plan_mul, pos, out_np, channel):
    import jax.numpy as jnp

    from ..ops import fastspmv as _fs
    from . import looplayout as _ll

    # under a compiled-loop trace, build the loop-capable (total) plan once —
    # it serves this n-space dispatch identically AND the edge-layout attempt
    loop_variant = _ll.probing() is not None or _ll.active() is not None
    plan = sp.plan("pull" if pull else "push", loop=loop_variant)
    n = plan.n
    ch = jnp.int32 if channel == np.int32 else jnp.float32
    # narrow integer outputs: contributions wrap to the output width
    # in-kernel so min/max compare the wrapped (C-semantics) values
    wrap = None
    if channel == np.int32 and out_np.kind in "iu" and out_np.itemsize < 4:
        wrap = (out_np.itemsize * 8, out_np.kind == "i")
    if plan_mul == "pair":
        # contribution is constantly 1: spmv_masked's pair channel answers
        # from the validity count scan alone (no value-channel expand)
        x_in = jnp.zeros((n,), ch)
    else:
        x_in = xv.astype(ch)
        if x_in.shape[0] != n:
            x_in = jnp.pad(x_in, (0, n - x_in.shape[0]))
    xs_in = xs
    if xs_in.shape[0] != n:
        xs_in = jnp.pad(xs_in, (0, n - xs_in.shape[0]))
    # structure hoisting (gb.compile/loop): when x's structure is a
    # trace-time constant and full, skip the structure channel entirely —
    # the traced DSL mxv then does identical work to the hand-written models
    import jax as _jax

    x_full = not isinstance(xs, _jax.core.Tracer) and bool(np.asarray(xs).all())
    from .collection_ops import _mesh_context

    ctx = _mesh_context()
    if ctx is not None and ctx.mesh.devices.size > 1 and channel == np.float32:
        # engaged mesh Context: the DSL's mxv/vxm runs the multi-chip
        # engine (reference Context semantics scope resources,
        # core/ss/context.py:19-151; here the resource is the mesh).
        # The sharded stack carries f32 channels; integer channels run
        # single-device.
        from ..parallel.fastspmv import sharded_spmv_masked

        splan = sp.sharded_plan("pull" if pull else "push", ctx.mesh)
        yv, ys = sharded_spmv_masked(splan, x_in, xs_in, add=add_name, mul=plan_mul)
    else:
        yv, ys = _fs.spmv_masked(plan, x_in, xs_in, add=add_name, mul=plan_mul, x_full=x_full, wrap=wrap)
    if pos is not None:
        _, delta = pos
        if delta:
            yv = yv + delta
        yv = jnp.where(ys, yv, jnp.zeros((), yv.dtype))
    return yv.astype(out_np), ys


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def sparse_reduce_axis(sp, monoid_t, axis):
    """reduce_rowwise (axis=1) / columnwise (axis=0) over sparse storage."""
    import jax.numpy as jnp

    out_np = np.dtype(monoid_t.type_.np_type)
    if axis == 1:
        seg = sp.device("rows_r")
        vals = sp.device("vals_r")
        n_out = sp.nrows
    else:
        seg = sp.device("cols_c")
        vals = sp.device("vals_c")
        n_out = sp.ncols
    contrib = vals.astype(out_np)
    valid = jnp.ones(contrib.shape, bool)
    return _segment_reduce(contrib, valid, seg, n_out, monoid_t)


def sparse_reduce_scalar(sp, monoid_t):
    """Full reduction to a scalar; returns (value, present) device scalars."""
    import jax.numpy as jnp

    out_np = np.dtype(monoid_t.type_.np_type)
    if sp.nvals == 0:
        return jnp.zeros((), out_np), jnp.asarray(False)
    vals = sp.device("vals_r").astype(out_np)
    name = monoid_t.parent.name
    if name == "plus":
        y = jnp.sum(vals)
    elif name == "times":
        y = jnp.prod(vals)
    elif name in {"min", "land"}:
        y = jnp.min(vals)
    elif name in {"max", "lor", "any"}:
        y = jnp.max(vals)
    else:
        import jax.lax as lax

        fn = monoid_t.fn

        def comb(a, b):
            return fn(a, b).astype(a.dtype)

        y = lax.associative_scan(comb, vals)[-1]
    if vals.dtype == jnp.bool_:
        y = y.astype(bool)
    return y, jnp.asarray(True)


# ---------------------------------------------------------------------------
# apply / select / positional patterns
# ---------------------------------------------------------------------------


def _pair_keys(rows, cols):
    """Structured (row, col) sort keys: lexicographic compare without the
    r*ncols+c encoding (which overflows int64 in the 2^60 index space)."""
    k = np.empty(len(rows), dtype=[("r", np.int64), ("c", np.int64)])
    k["r"] = rows
    k["c"] = cols
    return k


def sparse_ewise(a_sp, b_sp, op_t, how, out_dtype, ld=None, rd=None):
    """Sparse-sparse eWiseMult/Add/Union as a host merge-join on the sorted
    COO patterns + one device elementwise combine — no densify, so huge
    (2^60-scale) dimensions stay representable (reference: GrB_eWise*,
    core/matrix.py:1861-2151; hypersparse scale graphblas/__init__.py:210-213).
    """
    import jax.numpy as jnp

    out_np = np.dtype(out_dtype.np_type)
    t1 = np.dtype(op_t.type_.np_type)
    t2 = np.dtype(op_t.type2.np_type)
    ka = _pair_keys(a_sp.rows, a_sp.cols)
    kb = _pair_keys(b_sp.rows, b_sp.cols)
    # both row-major sorted: positional match via searchsorted
    pos = np.searchsorted(kb, ka)
    pos_c = np.minimum(pos, len(kb) - 1) if len(kb) else np.zeros(len(ka), np.int64)
    in_both_a = (len(kb) > 0) & (pos < len(kb))
    if len(kb):
        in_both_a &= kb[pos_c] == ka
    ia = np.flatnonzero(in_both_a)
    ib = pos[ia] if len(ia) else np.zeros(0, np.int64)

    def combine(av, bv):
        if len(av) == 0:
            return np.empty(0, out_np)
        if out_np.names is not None:
            # UDT: field dicts through the op, back to a structured array
            da = {f: jnp.asarray(av[f]) for f in av.dtype.names}
            db = {f: jnp.asarray(bv[f]) for f in bv.dtype.names}
            r = op_t.fn(da, db)
            out = np.empty(len(av), out_np)
            for f in out_np.names:
                out[f] = np.asarray(r[f])
            return out
        r = op_t.fn(jnp.asarray(av.astype(t1)), jnp.asarray(bv.astype(t2)))
        return np.asarray(r).astype(out_np)

    if how == "mult":
        vals = combine(a_sp.vals[ia], b_sp.vals[ib])
        return SparseMatrixData(a_sp.rows[ia], a_sp.cols[ia], vals, a_sp.nrows, a_sp.ncols)

    only_a = np.ones(len(ka), bool)
    only_a[ia] = False
    only_b = np.ones(len(kb), bool)
    only_b[ib] = False
    oa = np.flatnonzero(only_a)
    ob = np.flatnonzero(only_b)
    both_vals = combine(a_sp.vals[ia], b_sp.vals[ib])
    if how == "add":
        a_vals = a_sp.vals[oa].astype(out_np)
        b_vals = b_sp.vals[ob].astype(out_np)
    else:  # union: defaults substitute for the absent side
        a_vals = combine(a_sp.vals[oa], np.full(len(oa), rd, t2))
        b_vals = combine(np.full(len(ob), ld, t1), b_sp.vals[ob])
    rows = np.concatenate([a_sp.rows[ia], a_sp.rows[oa], b_sp.rows[ob]])
    cols = np.concatenate([a_sp.cols[ia], a_sp.cols[oa], b_sp.cols[ob]])
    vals = np.concatenate([both_vals, a_vals, b_vals])
    order = np.lexsort((cols, rows))
    return SparseMatrixData(
        rows[order], cols[order], vals[order], a_sp.nrows, a_sp.ncols
    )


def sparse_apply_values(sp, fn, out_np):
    """Entrywise op on present values; pattern unchanged."""
    new_vals = np.asarray(fn(sp.device("vals_r"))).astype(out_np)
    return sp.copy(vals=new_vals)


def sparse_apply_indexunary(sp, op_t, thunk_dev, out_np):
    """IndexUnary apply over present entries: f(val, i, j, thunk)."""
    import jax.numpy as jnp

    vals = sp.device("vals_r").astype(np.dtype(op_t.type_.np_type))
    rows = sp.device("rows_r").astype(_index_np())
    cols = sp.device("cols_r").astype(_index_np())
    res = op_t.fn(vals, rows, cols, thunk_dev)
    return sp.copy(vals=np.asarray(res).astype(out_np))


def sparse_select(sp, op_t, thunk_dev):
    """GrB_select on sparse storage: filter entries, keep sparse."""
    import jax.numpy as jnp

    if sp.nvals == 0:
        return sp.copy()
    vals = sp.device("vals_r")
    rows = sp.device("rows_r").astype(_index_np())
    cols = sp.device("cols_r").astype(_index_np())
    keep = np.asarray(op_t.fn(vals, rows, cols, thunk_dev)).astype(bool)
    return SparseMatrixData(
        sp.rows[keep], sp.cols[keep], sp.vals[keep], sp.nrows, sp.ncols
    )


def sparse_apply_positional(sp, which, delta, out_np):
    """Positional unary apply (rowindex/colindex) on sparse storage."""
    idx = sp.rows if which == "i" else sp.cols
    return sp.copy(vals=(idx + delta).astype(out_np))


# ---------------------------------------------------------------------------
# masked semiring SpGEMM (the BASELINE acceptance metric)
# ---------------------------------------------------------------------------

_SPGEMM_WMAX = 256  # segment width cap; hub lists split into chunk-pair tasks
_SPGEMM_EQ_BUDGET = 1 << 26  # eq-tensor elements per device batch


class SpgemmPlan:
    """Analyzed masked-SpGEMM tasks: per-width buckets of padded key/value
    tiles resident on device (the pattern-analysis step, done once per
    (A, B, M) pattern; re-executed cheaply when values change)."""

    __slots__ = ("m_rows", "m_cols", "n_entries", "buckets", "brick", "reduce_net", "_exec")

    def __init__(self, m_rows, m_cols, n_entries, buckets, brick=None, reduce_net=None):
        self.m_rows = m_rows
        self.m_cols = m_cols
        self.n_entries = n_entries
        self.buckets = buckets  # [((Wa, Wb), task_entry, multi_task, ak, av, bk, bv)]
        self.brick = brick  # SpgemmBrickPlan | None
        # scatter-free segment combine: (net1, net2, seg_start, has_task)
        # net1 routes the concatenated per-task outputs into entry-grouped
        # order; a segmented scan reduces each group; net2 routes each
        # group's last (total) slot to its entry position
        self.reduce_net = reduce_net
        self._exec = {}  # (sr, out_dtype, backend) -> jitted executor


def _build_reduce_net(buckets, n_entries):
    """Static permutation networks grouping the task partials by entry for
    the segmented combine: (net1, net2, segment ids, has_task)."""
    import jax.numpy as jnp

    from ..ops.fastspmv import _complete_permutation
    from ..ops.permute import build_permutation_plan, padded_size, plan_to_device

    sizes = [int(b[3].shape[1]) for b in buckets]
    tg = sum(sizes)
    tg_pad = padded_size(max(tg, n_entries, 256))
    gids = np.full(tg_pad, np.iinfo(np.int64).max, np.int64)
    pos = 0
    for b, size in zip(buckets, sizes):
        te = b[1]
        gids[pos : pos + len(te)] = te
        pos += size
    order = np.argsort(gids, kind="stable")
    net1 = plan_to_device(build_permutation_plan(order, validate=False))
    sorted_gids = gids[order]
    nvalid = int((sorted_gids != np.iinfo(np.int64).max).sum())
    seg_start = np.zeros(tg_pad, bool)
    seg_start[0] = True
    seg_start[1:] = sorted_gids[1:] != sorted_gids[:-1]
    from ..ops.segscan import segment_ids
    counts = np.bincount(sorted_gids[:nvalid], minlength=n_entries)
    has_task = counts > 0
    last = np.searchsorted(sorted_gids[:nvalid], np.arange(n_entries), side="right") - 1
    perm2 = np.full(tg_pad, -1, np.int64)
    perm2[np.flatnonzero(has_task)] = last[has_task]
    net2 = plan_to_device(build_permutation_plan(_complete_permutation(perm2, tg_pad), validate=False))
    return (net1, net2, jnp.asarray(segment_ids(seg_start)), jnp.asarray(has_task))


class SpgemmBrickPlan:
    """Matmul path for block-dense regions of C(M) = A (.) B: where the mask and
    both operands are dense in 128x128 bricks, the per-entry key intersections
    become batched brick matmuls (plus an indicator matmul for the match
    counts/structure).  The sparse remainder (A_rest x B plus A_dense x
    B_rest) stays on the eq-join kernel with rectangular tiles."""

    __slots__ = ("a_bricks", "b_bricks", "a_idx", "b_idx", "entry_cell", "kmax")

    def __init__(self, a_bricks, b_bricks, a_idx, b_idx, entry_cell, kmax):
        self.a_bricks = a_bricks  # device (NA+1, 128, 128) f32; last = zeros
        self.b_bricks = b_bricks  # device (NB+1, 128, 128) f32
        self.a_idx = a_idx  # device (CB, kmax) int32 into a_bricks
        self.b_idx = b_idx  # device (CB, kmax) int32 into b_bricks
        # per mask entry: flat cell in the (CB*16384,) brick output, or the
        # sentinel CB*16384 (a zero pad slot) for entries outside dense bricks
        self.entry_cell = entry_cell  # device (n_entries,) int32
        self.kmax = kmax


def _pow2ceil(x):
    return 1 << np.ceil(np.log2(np.maximum(x, 1))).astype(np.int64)


def _pow4ceil(x):
    """Quantize tile widths to powers of 4 (4, 16, 64, 256): fewer buckets
    means fewer kernel launches; padding waste is bounded at 4x of a cheap
    fully-vectorized compare."""
    lg = np.ceil(np.log2(np.maximum(x, 1)))
    return (1 << (2 * ((lg.astype(np.int64) + 1) // 2))).astype(np.int64)


def _build_eq_tasks(out, entry_idx, mr, mc, a_indptr, a_keys, a_vals, b_indptr, b_keys, b_vals):
    """Collect rectangular eq-join tasks for a set of mask entries against a
    CSR-like A-row / B-col segment layout, merging into ``out`` keyed by
    (Wa, Wb).  ``entry_idx`` are GLOBAL entry ids (several groups feed the
    same segment-combine space)."""
    if len(entry_idx) == 0:
        return
    da = (a_indptr[mr + 1] - a_indptr[mr]).astype(np.int64)
    db = (b_indptr[mc + 1] - b_indptr[mc]).astype(np.int64)
    wa_e = np.minimum(_SPGEMM_WMAX, np.maximum(4, _pow4ceil(da)))
    wb_e = np.minimum(_SPGEMM_WMAX, np.maximum(4, _pow4ceil(db)))
    nva = max(len(a_keys), 1)
    nvb = max(len(b_keys), 1)
    a_keys = a_keys if len(a_keys) else np.zeros(1, np.int64)
    b_keys = b_keys if len(b_keys) else np.zeros(1, np.int64)
    a_vals = a_vals if len(a_vals) else np.zeros(1, np.float64)
    b_vals = b_vals if len(b_vals) else np.zeros(1, np.float64)
    # keys only feed equality compares: int32 halves the gather traffic
    if max(int(a_keys.max(initial=0)), int(b_keys.max(initial=0))) < (1 << 31) - 2:
        a_keys = a_keys.astype(np.int32)
        b_keys = b_keys.astype(np.int32)
    pairs = wa_e * (1 << 20) + wb_e
    # one argsort groups entries by (Wa, Wb) — replaces a full-array scan
    # per distinct pair
    ok = (da > 0) & (db > 0)
    order = np.argsort(np.where(ok, pairs, -1), kind="stable")
    order = order[ok[order]]
    if len(order) == 0:
        return
    sorted_pairs = pairs[order]
    bounds = np.flatnonzero(np.concatenate([[True], sorted_pairs[1:] != sorted_pairs[:-1]]))
    bounds = np.concatenate([bounds, [len(order)]])
    for g in range(len(bounds) - 1):
        in_bucket = order[bounds[g] : bounds[g + 1]]
        key = int(sorted_pairs[bounds[g]])
        Wa, Wb = key >> 20, key & ((1 << 20) - 1)
        dab, dbb = da[in_bucket], db[in_bucket]
        na = -(-dab // Wa)
        nb = -(-dbb // Wb)
        ntasks = na * nb
        rep = np.repeat(np.arange(len(in_bucket)), ntasks)
        task_local = in_bucket[rep]
        task_entry = entry_idx[task_local]
        offs = np.concatenate([[0], np.cumsum(ntasks)])
        local = np.arange(offs[-1]) - offs[rep]
        nb_rep = np.repeat(nb, ntasks)
        ta = local // np.maximum(nb_rep, 1)
        tb = local % np.maximum(nb_rep, 1)
        a_start = (a_indptr[mr[task_local]] + ta * Wa).astype(np.int64)
        b_start = (b_indptr[mc[task_local]] + tb * Wb).astype(np.int64)
        a_len = np.minimum(da[task_local] - ta * Wa, Wa)
        b_len = np.minimum(db[task_local] - tb * Wb, Wb)
        # (T, W) build: per-task W-windows are contiguous in the source
        # arrays, so the big gathers stay cache-friendly (building (W, T)
        # directly measured SLOWER — scattered gather order).  Single
        # clipped int index temporary per side; values gather through the
        # same clipped index then mask (f32, not promoted).
        ai = a_start[:, None] + np.arange(Wa, dtype=np.int64)[None, :]
        np.minimum(ai, nva - 1, out=ai)
        bi = b_start[:, None] + np.arange(Wb, dtype=np.int64)[None, :]
        np.minimum(bi, nvb - 1, out=bi)
        am = np.arange(Wa)[None, :] < a_len[:, None]
        bm = np.arange(Wb)[None, :] < b_len[:, None]
        ak = np.where(am, a_keys[ai], np.asarray(-1, a_keys.dtype))
        bk = np.where(bm, b_keys[bi], np.asarray(-2, b_keys.dtype))
        av = np.where(am, a_vals[ai], np.zeros((), a_vals.dtype))
        bv = np.where(bm, b_vals[bi], np.zeros((), b_vals.dtype))
        out.setdefault((Wa, Wb), []).append((task_entry, ak, av, bk, bv))


def _finalize_eq_buckets(task_groups, n_entries_cap):
    """Pad merged (Wa, Wb) task groups and upload in the kernel's
    tasks-on-lanes layout."""
    import jax.numpy as jnp

    buckets = []
    for (Wa, Wb), parts in sorted(task_groups.items()):
        task_entry = np.concatenate([p[0] for p in parts])
        ak = np.concatenate([p[1] for p in parts])
        av = np.concatenate([p[2] for p in parts])
        bk = np.concatenate([p[3] for p in parts])
        bv = np.concatenate([p[4] for p in parts])
        if len(parts) > 1 and np.any(task_entry[1:] < task_entry[:-1]):
            # keep tasks grouped by entry id: the exotic-monoid segment
            # reduce relies on contiguous segments
            order = np.argsort(task_entry, kind="stable")
            task_entry = task_entry[order]
            ak, av, bk, bv = ak[order], av[order], bk[order], bv[order]
        T = len(task_entry)
        # pad task count to the chunk size: a multiple of 512 tasks within
        # the per-chunk compare budget, never larger than the padded task
        # count itself
        chunk = max(512, _SPGEMM_EQ_BUDGET // (Wa * Wb) // 512 * 512)
        chunk = min(chunk, -(-T // 512) * 512)
        pad = (-T) % chunk
        if pad:
            ak = np.pad(ak, ((0, pad), (0, 0)), constant_values=-1)
            bk = np.pad(bk, ((0, pad), (0, 0)), constant_values=-2)
            av = np.pad(av, ((0, pad), (0, 0)))
            bv = np.pad(bv, ((0, pad), (0, 0)))
        idt = np.int32 if n_entries_cap < (1 << 31) else np.int64
        kdt32 = np.int32 if max(int(ak.max(initial=0)), int(bk.max(initial=0)), 2) < (1 << 31) else np.int64
        multi = np.ones(T, bool)  # merged groups: entries may span buckets
        buckets.append(
            (
                (Wa, Wb),
                task_entry,
                multi,
                jnp.asarray(np.ascontiguousarray(ak.T.astype(kdt32, copy=False))),
                jnp.asarray(np.ascontiguousarray(av.T)),
                jnp.asarray(np.ascontiguousarray(bk.T.astype(kdt32, copy=False))),
                jnp.asarray(np.ascontiguousarray(bv.T)),
                chunk,
                jnp.asarray(task_entry.astype(idt)),
            )
        )
    return buckets


def _in_sorted(values, sorted_arr):
    if sorted_arr.size == 0:
        return np.zeros(values.shape, bool)
    pos = np.searchsorted(sorted_arr, values)
    pos_c = np.minimum(pos, len(sorted_arr) - 1)
    return sorted_arr[pos_c] == values


def _analyze_bricks(a_sp, b_sp, b_order, m_rows, m_cols, thresh):
    """Find block-dense structure; returns (SpgemmBrickPlan, in_dense_entry)
    or (None, None) when the pattern has no brick-worthy region."""
    import jax.numpy as jnp

    nbc = -(-b_sp.ncols // 128)
    nbk = -(-a_sp.ncols // 128)
    cb = (m_rows >> 7) * nbc + (m_cols >> 7)
    ubr, ucnt = np.unique(cb, return_counts=True)
    dense_cb = ubr[ucnt >= thresh]
    ab = (a_sp.rows >> 7) * nbk + (a_sp.cols >> 7)
    uab, uacnt = np.unique(ab, return_counts=True)
    dense_ab = uab[uacnt >= thresh]
    b_rows = b_sp.rows[b_order]
    b_cols = b_sp.cols[b_order]
    bb = (b_rows >> 7) * nbc + (b_cols >> 7)
    udb, udcnt = np.unique(bb, return_counts=True)
    dense_bb = udb[udcnt >= thresh]
    if dense_cb.size == 0 or dense_ab.size == 0 or dense_bb.size == 0:
        return None, None
    in_dense = _in_sorted(cb, dense_cb)
    a_in = _in_sorted(ab, dense_ab)
    b_in = _in_sorted(bb, dense_bb)

    NA, NB, CB = len(dense_ab), len(dense_bb), len(dense_cb)
    a_bricks = np.zeros((NA + 1, 128, 128), np.float32)
    apos = np.searchsorted(dense_ab, ab[a_in])
    a_bricks[apos, a_sp.rows[a_in] & 127, a_sp.cols[a_in] & 127] = a_sp.vals[a_in].astype(np.float32)
    b_bricks = np.zeros((NB + 1, 128, 128), np.float32)
    bpos = np.searchsorted(dense_bb, bb[b_in])
    b_bricks[bpos, b_rows[b_in] & 127, b_cols[b_in] & 127] = b_sp.vals[b_order][b_in].astype(np.float32)

    # task lists: for C brick (bi, bj), every k with A(bi, k) and B(k, bj) dense
    a_by_row = {}
    for idx, key in enumerate(dense_ab):
        a_by_row.setdefault(int(key) // nbk, []).append((int(key) % nbk, idx))
    b_by_col = {}
    for idx, key in enumerate(dense_bb):
        b_by_col.setdefault(int(key) % nbc, {})[int(key) // nbc] = idx
    tasks = []
    for c_i, key in enumerate(dense_cb):
        bi, bj = int(key) // nbc, int(key) % nbc
        row_ks = a_by_row.get(bi, [])
        col_ks = b_by_col.get(bj, {})
        tasks.append([(ai_, col_ks[k]) for k, ai_ in row_ks if k in col_ks])
    kmax = max((len(t) for t in tasks), default=0)
    if kmax == 0:
        return None, None
    a_idx = np.full((CB, kmax), NA, np.int32)
    b_idx = np.full((CB, kmax), NB, np.int32)
    for c_i, t in enumerate(tasks):
        for j, (ai_, bi_) in enumerate(t):
            a_idx[c_i, j] = ai_
            b_idx[c_i, j] = bi_

    # per-entry flat cell into the (CB*16384,) brick output (+1 zero pad slot)
    pos = np.searchsorted(dense_cb, cb)
    cell = np.full(len(m_rows), CB * 16384, np.int64)
    cell[in_dense] = pos[in_dense] * 16384 + (m_rows[in_dense] & 127) * 128 + (m_cols[in_dense] & 127)
    cdt = np.int32 if CB * 16384 + 1 < (1 << 31) else np.int64
    plan = SpgemmBrickPlan(
        jnp.asarray(a_bricks),
        jnp.asarray(b_bricks),
        jnp.asarray(a_idx),
        jnp.asarray(b_idx),
        jnp.asarray(cell.astype(cdt)),
        kmax,
    )
    return plan, in_dense


def sparse_spgemm_analyze(a_sp, b_sp, m_rows, m_cols, *, bricks=False, brick_thresh=1024, reduce_net=False):
    """Build the task plan for C(M) = A (.) B (host-side pattern analysis).

    ``bricks=True`` additionally detects 128x128 block-dense regions (of the
    mask AND both operands) and plans them as batched matmuls; only valid
    when the semiring executes as plus_pair / plus_times over f32 (the
    execute step asserts this).  The remainder — sparse-region entries, plus
    each dense entry's (A_rest x B) and (A_dense x B_rest) contributions —
    stays on the rectangular eq-join path.
    """
    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    n_entries = len(m_rows)
    a_indptr = np.searchsorted(a_sp.rows, np.arange(a_sp.nrows + 1))
    b_order = b_sp.col_order()
    b_order_cols = b_sp.cols[b_order]
    b_indptr = np.searchsorted(b_order_cols, np.arange(b_sp.ncols + 1))
    a_keys_all = a_sp.cols
    a_vals_all = a_sp.vals
    b_keys_all = b_sp.rows[b_order]
    b_vals_all = b_sp.vals[b_order]
    if max(a_sp.ncols, b_sp.nrows, 2) < (1 << 31):
        # narrow keys before tile construction: tiles are the big host arrays
        a_keys_all = a_keys_all.astype(np.int32)
        b_keys_all = b_keys_all.astype(np.int32)

    brick = in_dense = None
    if bricks:
        brick, in_dense = _analyze_bricks(a_sp, b_sp, b_order, m_rows, m_cols, brick_thresh)

    all_idx = np.arange(n_entries)
    if brick is None:
        groups = {}
        _build_eq_tasks(
            groups, all_idx, m_rows, m_cols, a_indptr, a_keys_all, a_vals_all, b_indptr, b_keys_all, b_vals_all
        )
        buckets = _finalize_eq_buckets(groups, n_entries)
        rnet = _build_reduce_net(buckets, n_entries) if reduce_net and buckets else None
        return SpgemmPlan(m_rows, m_cols, n_entries, buckets, None, rnet)

    # split operand entries into dense-brick / rest parts (order-preserving
    # boolean selection keeps A row-sorted and B col-sorted)
    nbk = -(-a_sp.ncols // 128)
    nbc = -(-b_sp.ncols // 128)
    ab = (a_sp.rows >> 7) * nbk + (a_sp.cols >> 7)
    uab, uacnt = np.unique(ab, return_counts=True)
    a_in = _in_sorted(ab, uab[uacnt >= brick_thresh])
    b_rows_o = b_sp.rows[b_order]
    b_cols_o = b_sp.cols[b_order]
    bb = (b_rows_o >> 7) * nbc + (b_cols_o >> 7)
    udb, udcnt = np.unique(bb, return_counts=True)
    b_in = _in_sorted(bb, udb[udcnt >= brick_thresh])

    def sub_rows(sel):
        rows = a_sp.rows[sel]
        return np.searchsorted(rows, np.arange(a_sp.nrows + 1)), a_keys_all[sel], a_vals_all[sel]

    def sub_cols(sel):
        cols = b_order_cols[sel]
        return np.searchsorted(cols, np.arange(b_sp.ncols + 1)), b_keys_all[sel], b_vals_all[sel]

    ad_indptr, ad_keys, ad_vals = sub_rows(a_in)
    ar_indptr, ar_keys, ar_vals = sub_rows(~a_in)
    br_indptr, br_keys, br_vals = sub_cols(~b_in)

    sparse_idx = all_idx[~in_dense]
    dense_idx = all_idx[in_dense]
    groups = {}
    _build_eq_tasks(
        groups, sparse_idx, m_rows[~in_dense], m_cols[~in_dense],
        a_indptr, a_keys_all, a_vals_all, b_indptr, b_keys_all, b_vals_all,
    )
    # dense-entry remainder: A_rest x B_full  +  A_dense x B_rest
    _build_eq_tasks(
        groups, dense_idx, m_rows[in_dense], m_cols[in_dense],
        ar_indptr, ar_keys, ar_vals, b_indptr, b_keys_all, b_vals_all,
    )
    _build_eq_tasks(
        groups, dense_idx, m_rows[in_dense], m_cols[in_dense],
        ad_indptr, ad_keys, ad_vals, br_indptr, br_keys, br_vals,
    )
    buckets = _finalize_eq_buckets(groups, n_entries)
    rnet = _build_reduce_net(buckets, n_entries) if reduce_net and buckets else None
    return SpgemmPlan(m_rows, m_cols, n_entries, buckets, brick, rnet)


def sparse_spgemm_execute(plan, sr, out_dtype, *, keep_on_device=False):
    """Run the analyzed masked SpGEMM: one device dispatch per width bucket;
    task partials segment-combine by entry ON DEVICE (sorted task order).

    keep_on_device=True returns (values (n_entries,), hit, flops) as device
    arrays — no host transfer (the result of one algebra step usually feeds
    the next device op).
    """
    import jax
    import jax.numpy as jnp

    mul = sr.binaryop
    addm = sr.monoid
    name = addm.parent.name
    out_np = np.dtype(out_dtype.np_type)
    n_entries = plan.n_entries

    bucket_meta = [(b[0], b[7]) for b in plan.buckets]  # ((Wa, Wb), chunk) static
    brick = plan.brick
    if brick is not None and not (
        name == "plus" and mul.parent.name in ("pair", "times") and out_np == np.float32
    ):
        raise ValueError(
            "brick-analyzed SpGEMM plan requires a plus_pair/plus_times f32 semiring; "
            "re-analyze with bricks=False"
        )

    def _build_exec():
        # jitted ONCE per (plan, semiring, dtype): plans are reused across
        # value changes, so per-call re-tracing would dominate the runtime

        @jax.jit
        def exec_all(bucket_arrays, brick_arrays, rnet):
            from ..ops.permute import apply_plan
            from ..ops.segscan import _ident as _scan_ident
            from ..ops.segscan import segmented_reduce

            acc = jnp.zeros((n_entries,), out_np)
            hit = jnp.zeros((n_entries,), bool)
            flops = jnp.zeros((), jnp.int32)
            scan_op = {"plus": "add", "min": "min", "max": "max", "any": "max"}.get(name)
            if name in _SEGMENT_OPS:
                vs, nms, idss = [], [], []
                for (_W, chunk), (ak, av, bk, bv, ids) in zip(bucket_meta, bucket_arrays):
                    v, nm = bucket_body(ak, av, bk, bv, ids, chunk)
                    vs.append(v)
                    nms.append(nm)
                    idss.append(ids)
                    flops = flops + jnp.sum(nm[: ids.shape[0]])
                if vs and rnet is not None and scan_op is not None and out_np == np.float32:
                    # combine: static networks + a sorted segmented reduce
                    net1, net2, seg, has_task = rnet
                    stream_v = jnp.concatenate(vs).astype(jnp.float32)
                    stream_nm = jnp.concatenate(nms).astype(jnp.int32)
                    tg_pad = seg.shape[0]
                    pad = tg_pad - stream_v.shape[0]
                    if pad:
                        stream_v = jnp.concatenate([stream_v, jnp.zeros((pad,), jnp.float32)])
                        stream_nm = jnp.concatenate([stream_nm, jnp.zeros((pad,), jnp.int32)])
                    sv = apply_plan(stream_v, net1)
                    snm = apply_plan(stream_nm, net1)
                    ident = _scan_ident(scan_op, np.float32)
                    sv = jnp.where(snm > 0, sv, ident)
                    scanned_v = segmented_reduce(sv, seg, scan_op, tg_pad)
                    scanned_nm = segmented_reduce(snm, seg, "add", tg_pad)
                    out_v = apply_plan(scanned_v, net2)[:n_entries]
                    out_nm = apply_plan(scanned_nm, net2)[:n_entries]
                    hit = has_task & (out_nm > 0)
                    acc = jnp.where(hit, out_v, jnp.zeros((), jnp.float32)).astype(out_np)
                elif vs:
                    # standard monoid: ONE global unordered segment reduce
                    # (2 scatters total, not 2 per bucket)
                    all_v = jnp.concatenate([v[: i.shape[0]] for v, i in zip(vs, idss)])
                    all_nm = jnp.concatenate([nm[: i.shape[0]] for nm, i in zip(nms, idss)])
                    all_ids = jnp.concatenate(idss)
                    acc, hit = _segment_reduce(all_v, all_nm > 0, all_ids, n_entries, addm)
            else:
                for (_W, chunk), (ak, av, bk, bv, ids) in zip(bucket_meta, bucket_arrays):
                    v, nm = bucket_body(ak, av, bk, bv, ids, chunk)
                    v, nm = v[: ids.shape[0]], nm[: ids.shape[0]]
                    y, ys = _segment_reduce(v, nm > 0, ids, n_entries, addm)
                    # an entry's tasks may span several buckets (dense
                    # remainders): combine with the monoid, don't overwrite
                    both = ys & hit
                    acc = jnp.where(both, addm.fn(acc, y).astype(out_np), jnp.where(ys, y, acc))
                    hit = hit | ys
                    flops = flops + jnp.sum(nm)
            if brick_arrays is not None:
                a_bricks, b_bricks, a_idx, b_idx, entry_cell = brick_arrays
                mul_pair = mul.parent.name == "pair"

                def step(k, carry):
                    accv, accc = carry
                    a = a_bricks[a_idx[:, k]]
                    b = b_bricks[b_idx[:, k]]
                    # indicator products: 0/1 inputs are exact in TF32 and
                    # each cell sums at most 128 ones in f32, so the default
                    # precision is exact here
                    cnt = jnp.matmul(
                        (a != 0).astype(jnp.float32),
                        (b != 0).astype(jnp.float32),
                        preferred_element_type=jnp.float32,
                    )
                    accc = accc + cnt
                    if mul_pair:
                        accv = accv + cnt
                    else:
                        # full f32 products: the default precision may run
                        # in TF32 on the GPU and round the inputs
                        accv = accv + jnp.matmul(
                            a, b, precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32,
                        )
                    return accv, accc

                CB = a_idx.shape[0]
                z = jnp.zeros((CB, 128, 128), jnp.float32)
                accv, accc = jax.lax.fori_loop(0, brick.kmax, step, (z, z))
                pad1 = jnp.zeros((1,), jnp.float32)
                dv = jnp.concatenate([accv.reshape(-1), pad1])[entry_cell]
                dc = jnp.concatenate([accc.reshape(-1), pad1])[entry_cell]
                dhit = dc > 0
                acc = jnp.where(dhit & hit, acc + dv.astype(out_np), jnp.where(dhit, dv.astype(out_np), acc))
                hit = hit | dhit
                # nmatch units: the caller doubles once into flops
                flops = flops + jnp.sum(dc, dtype=jnp.int32)
            return acc, hit, flops

        return exec_all

    def bucket_body(akT, avT, bkT, bvT, entry_ids, chunk):
        return _eq_bucket(akT, avT, bkT, bvT, chunk, mul, addm, out_np)

    if plan.buckets or brick is not None:
        key = (sr, out_dtype.name, jax.default_backend())
        exec_all = plan._exec.get(key)
        if exec_all is None:
            exec_all = plan._exec[key] = _build_exec()
        arrays = tuple((b[3], b[4], b[5], b[6], b[8]) for b in plan.buckets)
        brick_arrays = None
        if brick is not None:
            brick_arrays = (brick.a_bricks, brick.b_bricks, brick.a_idx, brick.b_idx, brick.entry_cell)
        acc, hit, flops_dev = exec_all(arrays, brick_arrays, plan.reduce_net)
    else:
        acc = jnp.zeros((n_entries,), out_np)
        hit = jnp.zeros((n_entries,), bool)
        flops_dev = jnp.zeros((), jnp.int32)
    flops_dev = 2 * flops_dev
    if keep_on_device:
        return acc, hit, flops_dev
    keep = np.asarray(hit)
    vals_host = np.asarray(acc)
    return (
        plan.m_rows[keep],
        plan.m_cols[keep],
        vals_host[keep].astype(out_np),
        int(flops_dev),
    )


def _eq_bucket(akT, avT, bkT, bvT, chunk, mul, addm, out_np):
    """One width bucket of the masked-SpGEMM dot method: task t intersects
    two sorted key lists (columns of ``akT``/``bkT``, shape (W, T)) and
    returns out[t] = ADD over ak[k, t] == bk[l, t] of MUL(av[k, t], bv[l, t])
    plus the match count.  Missing A keys are -1 and missing B keys -2, so
    pad slots never match.  Tasks run in chunks of ``chunk`` through
    ``lax.map``; XLA fuses each chunk's broadcast compare + select + reduce.
    Returns untrimmed (values, nmatch) of the padded task count."""
    import jax
    import jax.numpy as jnp

    name = addm.parent.name
    a_np = np.dtype(mul.type_.np_type)
    b_np = np.dtype(mul.type2.np_type)
    ak, av, bk, bv = akT.T, avT.T, bkT.T, bvT.T

    def one(chunk_args):
        akk, avv, bkk, bvv = chunk_args
        eq = akk[:, :, None] == bkk[:, None, :]
        prod = mul.fn(
            avv.astype(a_np)[:, :, None], bvv.astype(b_np)[:, None, :]
        ).astype(out_np)
        nmatch = jnp.sum(eq.astype(jnp.int32), axis=(1, 2))
        if name == "plus":
            val = jnp.sum(jnp.where(eq, prod, jnp.zeros((), out_np)), axis=(1, 2))
        elif name in {"min", "land"}:
            val = jnp.min(jnp.where(eq, prod, _extreme(out_np, "max")), axis=(1, 2))
        elif name in {"max", "lor", "any"}:
            val = jnp.max(jnp.where(eq, prod, _extreme(out_np, "min")), axis=(1, 2))
        elif name == "times":
            val = jnp.prod(jnp.where(eq, prod, jnp.ones((), out_np)), axis=(1, 2))
        else:
            iv = jnp.asarray(addm.identity, out_np)
            eff = jnp.where(eq, prod, iv).reshape(prod.shape[0], -1)
            fn = addm.fn
            val = jax.lax.associative_scan(
                lambda x, y: fn(x, y).astype(out_np), eff, axis=1
            )[:, -1]
        return val, nmatch

    nchunks = ak.shape[0] // chunk
    resh = lambda x: x.reshape(nchunks, chunk, x.shape[1])  # noqa: E731
    vals, nmatch = jax.lax.map(one, (resh(ak), resh(av), resh(bk), resh(bv)))
    return vals.reshape(-1), nmatch.reshape(-1)


def sparse_mxm_masked(a_sp, b_sp, m_rows, m_cols, sr, out_dtype):
    """C(M) = A ⊕.⊗ B over sparse operands, output restricted to M's pattern.

    The dot method (the analogue of SuiteSparse's masked dot,
    axb_method=dot — reference: core/ss/descriptor.py:76-82): for each
    masked (i, j), intersect A's row-i list with B's column-j list.  Entries
    bucket by power-of-2 list width (hub lists split into chunk-pair tasks,
    monoid-accumulated), and each width bucket runs as ONE device dispatch
    evaluating the full W×W pairwise key-equality as one fused compare+reduce — no gathers in
    the compute, any semiring.  Returns (rows, cols, values, flops); flops
    counts the multiply-adds actually performed (2 × intersections found).
    """
    out_np = np.dtype(out_dtype.np_type)
    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    if len(m_rows) == 0 or a_sp.nvals == 0 or b_sp.nvals == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, out_np), 0
    use_bricks = (
        sr.monoid.parent.name == "plus"
        and sr.binaryop.parent.name in ("pair", "times")
        and out_np == np.float32
    )
    use_net = sr.monoid.parent.name in ("plus", "min", "max", "any") and out_np == np.float32
    plan = sparse_spgemm_analyze(a_sp, b_sp, m_rows, m_cols, bricks=use_bricks, reduce_net=use_net)
    return sparse_spgemm_execute(plan, sr, out_dtype)


def _np_monoid_fn(name, addm):
    table = {
        "plus": lambda a, b: a + b,
        "times": lambda a, b: a * b,
        "min": min,
        "max": max,
        "lor": lambda a, b: bool(a) or bool(b),
        "land": lambda a, b: bool(a) and bool(b),
        "any": lambda a, b: b,
    }
    if name in table:
        return table[name]
    fn = addm.fn
    return lambda a, b: np.asarray(fn(a, b))[()]


# ---------------------------------------------------------------------------
# Sparse Vector storage (reference: hypersparse vectors to 2^60,
# /root/reference/graphblas/core/vector.py:682+, graphblas/__init__.py:210-213)
# ---------------------------------------------------------------------------


class SparseVectorData:
    """Canonical sorted-unique (index, value) arrays for one Vector."""

    __slots__ = ("idx", "vals", "size", "_dev")

    def __init__(self, idx, vals, size):
        self.idx = idx  # np.int64, sorted unique
        self.vals = vals  # np array of the Vector dtype
        self.size = int(size)
        self._dev = {}

    @classmethod
    def from_arrays(cls, idx, vals, size, dup_op=None, *, sorted_dedup=False):
        idx = np.asarray(idx, np.int64).reshape(-1)
        vals = np.asarray(vals).reshape(-1)
        if not sorted_dedup and idx.size:
            order = np.argsort(idx, kind="stable")
            idx, vals = idx[order], vals[order]
            dup = idx[1:] == idx[:-1]
            if dup.any():
                rows, _, vals = _combine_dups(idx, np.zeros_like(idx), vals, dup, dup_op)
                idx = rows
        return cls(idx, vals, size)

    @property
    def nvals(self):
        return int(self.idx.size)

    def copy(self, vals=None):
        return SparseVectorData(self.idx, self.vals if vals is None else vals, self.size)

    def device(self, key):
        import jax

        if key not in self._dev:
            import jax.numpy as jnp

            with jax.ensure_compile_time_eval():
                if key == "idx":
                    idt = np.int32 if self.size <= _INT32_MAX else np.int64
                    return self._dev.setdefault(key, jnp.asarray(self.idx.astype(idt)))
                if key == "vals":
                    return self._dev.setdefault(key, jnp.asarray(self.vals))
                raise KeyError(key)  # pragma: no cover
        return self._dev[key]

    def densify(self, np_dtype, *, limit=None):
        import jax.numpy as jnp

        limit = _densify_limit() if limit is None else limit
        if self.size > limit:
            raise _exc.OutOfMemory(
                f"operation requires densifying a size-{self.size} sparse Vector "
                f"(> tx.config['densify_limit']={limit}); use sparse-supported ops "
                "or raise the limit"
            )
        dv = np.zeros(self.size, self.vals.dtype)
        ds = np.zeros(self.size, bool)
        dv[self.idx] = self.vals
        ds[self.idx] = True
        from .utils import device_asarray

        return device_asarray(dv), jnp.asarray(ds)


def _np_reduce_groups(vals, starts, name, monoid_t, out_np):
    """Reduce each sorted group (given by ``starts``) with the named monoid
    on the host; generic monoids run the op fn pairwise."""
    np_fn = _NP_COMBINE.get(name)
    if np_fn is not None:
        return np_fn.reduceat(vals, starts).astype(out_np, copy=False)
    if name == "any":
        ends = np.concatenate([starts[1:], [len(vals)]]) - 1
        return vals[ends].astype(out_np, copy=False)
    fn = monoid_t.fn
    ends = np.concatenate([starts[1:], [len(vals)]])
    out = np.empty(len(starts), out_np)
    for gi, (s0, e0) in enumerate(zip(starts, ends)):
        acc = vals[s0]
        for k in range(s0 + 1, e0):
            acc = np.asarray(fn(acc, vals[k]))
        out[gi] = acc
    return out


def sparse_vec_ewise(a, b, op_t, how, out_dtype, ld=None, rd=None):
    """Sparse-sparse vector eWiseMult/Add/Union: host merge-join on sorted
    index lists + one device combine (no densify at any size)."""
    out_np = np.dtype(out_dtype.np_type)
    t1 = np.dtype(op_t.type_.np_type)
    t2 = np.dtype(op_t.type2.np_type)
    pos = np.searchsorted(b.idx, a.idx)
    pos_c = np.minimum(pos, max(len(b.idx) - 1, 0))
    in_both = (len(b.idx) > 0) & (pos < len(b.idx))
    if len(b.idx):
        in_both &= b.idx[pos_c] == a.idx
    ia = np.flatnonzero(in_both)
    ib = pos[ia] if len(ia) else np.zeros(0, np.int64)

    def combine(av, bv):
        if len(av) == 0:
            return np.empty(0, out_np)
        import jax.numpy as jnp

        r = op_t.fn(jnp.asarray(av.astype(t1)), jnp.asarray(bv.astype(t2)))
        return np.asarray(r).astype(out_np)

    if how == "mult":
        return SparseVectorData(a.idx[ia], combine(a.vals[ia], b.vals[ib]), a.size)
    only_a = np.ones(len(a.idx), bool)
    only_a[ia] = False
    only_b = np.ones(len(b.idx), bool)
    only_b[ib] = False
    oa = np.flatnonzero(only_a)
    ob = np.flatnonzero(only_b)
    both_vals = combine(a.vals[ia], b.vals[ib])
    if how == "add":
        a_vals = a.vals[oa].astype(out_np)
        b_vals = b.vals[ob].astype(out_np)
    else:
        a_vals = combine(a.vals[oa], np.full(len(oa), rd, t2))
        b_vals = combine(np.full(len(ob), ld, t1), b.vals[ob])
    idx = np.concatenate([a.idx[ia], a.idx[oa], b.idx[ob]])
    vals = np.concatenate([both_vals, a_vals, b_vals])
    order = np.argsort(idx, kind="stable")
    return SparseVectorData(idx[order], vals[order], a.size)


def sparse_vec_apply_values(sv, fn, out_np):
    import jax.numpy as jnp

    if sv.nvals == 0:
        return sv.copy(vals=sv.vals.astype(out_np))
    res = np.asarray(fn(jnp.asarray(sv.vals))).astype(out_np)
    return sv.copy(vals=res)


def sparse_vec_apply_indexunary(sv, op_t, thunk_dev, out_np):
    import jax.numpy as jnp

    if sv.nvals == 0:
        return sv.copy(vals=sv.vals.astype(out_np))
    vals = jnp.asarray(sv.vals.astype(np.dtype(op_t.type_.np_type)))
    rows = jnp.asarray(sv.idx)
    res = op_t.fn(vals, rows, jnp.zeros_like(rows), thunk_dev)
    return sv.copy(vals=np.asarray(res).astype(out_np))


def sparse_vec_select(sv, op_t, thunk_dev):
    import jax.numpy as jnp

    if sv.nvals == 0:
        return sv.copy()
    vals = jnp.asarray(sv.vals)
    rows = jnp.asarray(sv.idx)
    keep = np.asarray(op_t.fn(vals, rows, jnp.zeros_like(rows), thunk_dev)).astype(bool)
    return SparseVectorData(sv.idx[keep], sv.vals[keep], sv.size)


def sparse_vec_apply_positional(sv, which, delta, out_np):
    idx = sv.idx if which == "i" else np.zeros_like(sv.idx)
    return sv.copy(vals=(idx + delta).astype(out_np))


def sparse_vec_reduce_scalar(sv, monoid_t):
    import jax.numpy as jnp

    out_np = np.dtype(monoid_t.type_.np_type)
    if sv.nvals == 0:
        return jnp.zeros((), out_np), jnp.asarray(False)
    name = monoid_t.parent.name
    vals = sv.vals.astype(out_np)
    out = _np_reduce_groups(vals, np.zeros(1, np.int64), name, monoid_t, out_np)
    return jnp.asarray(out[0]), jnp.asarray(True)


def sparse_mxv_sv(sp, pull, a_first, sv, sr, out_dtype):
    """Semiring mxv/vxm with a SPARSE vector operand -> SparseVectorData.

    Host path (O(E log nnz(x))): the scalable-correctness route for huge
    dimensions where neither the vector nor the output can be dense.
    Reference: GrB_mxv core/matrix.py:2203 over hypersparse operands.
    """
    out_np = np.dtype(out_dtype.np_type)
    n_out = sp.nrows if pull else sp.ncols
    if pull:
        dst, src, avals = sp.rows, sp.cols, sp.vals
    else:
        order = sp.col_order()
        dst, src, avals = sp.cols[order], sp.rows[order], sp.vals[order]
    # join edges against the vector pattern
    pos = np.searchsorted(sv.idx, src)
    pos_c = np.minimum(pos, max(len(sv.idx) - 1, 0))
    valid = (len(sv.idx) > 0) & (pos < len(sv.idx))
    if len(sv.idx):
        valid &= sv.idx[pos_c] == src
    sel = np.flatnonzero(valid)
    if len(sel) == 0:
        return SparseVectorData(np.empty(0, np.int64), np.empty(0, out_np), n_out)
    dstv = dst[sel]
    mul = sr.binaryop
    addm = sr.monoid
    pos_mul = mul.positional
    if pos_mul is not None:
        which, delta = pos_mul
        role = _positional_role(which, a_first)
        if role == "src":
            contrib = (src[sel] + delta).astype(out_np)
        elif role == "dst":
            contrib = (dstv + delta).astype(out_np)
        else:
            contrib = np.full(len(sel), delta, out_np)
    else:
        import jax.numpy as jnp

        a_c = avals[sel].astype(np.dtype((mul.type_ if a_first else mul.type2).np_type))
        x_c = sv.vals[pos_c[sel]].astype(np.dtype((mul.type2 if a_first else mul.type_).np_type))
        r = mul.fn(jnp.asarray(a_c), jnp.asarray(x_c)) if a_first else mul.fn(jnp.asarray(x_c), jnp.asarray(a_c))
        contrib = np.asarray(r).astype(out_np)
    # group by dst (already sorted in dst-major order for both directions)
    starts = np.flatnonzero(np.concatenate([[True], dstv[1:] != dstv[:-1]]))
    out_idx = dstv[starts]
    monoid_t = addm if addm.type_.np_type == out_np else _retype_monoid(addm, out_dtype)
    out_vals = _np_reduce_groups(contrib, starts, addm.parent.name, monoid_t, out_np)
    return SparseVectorData(out_idx, out_vals, n_out)


# ---------------------------------------------------------------------------
# Sparse extract / assign / delete (host-side pattern surgery)
# Reference: _prep_for_extract core/matrix.py:3051-3087, _prep_for_assign
# core/matrix.py:3116-3529 — here over host-canonical COO with no densify,
# so the FastSV-style assign/extract hot loops work at any dimension.
# ---------------------------------------------------------------------------


def _ix_arr(ix):
    """Materialized np index array for a _DimIndex, or None for kind 'all'."""
    if ix.kind == "all":
        return None
    return np.atleast_1d(np.asarray(ix.index, np.int64))


def _join_positions(entry_keys, ixarr):
    """All (entry, output-position) matches of sorted ``entry_keys`` against
    index array ``ixarr`` (which may repeat values).  Returns
    (entry_sel, out_pos)."""
    order = np.argsort(ixarr, kind="stable")
    sorted_ix = ixarr[order]
    lo = np.searchsorted(sorted_ix, entry_keys, "left")
    hi = np.searchsorted(sorted_ix, entry_keys, "right")
    cnt = hi - lo
    entry_sel = np.repeat(np.arange(len(entry_keys)), cnt)
    total = int(cnt.sum())
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    out_pos = order[np.repeat(lo, cnt) + offs]
    return entry_sel, out_pos


def _in_index(values, ixarr):
    """Membership of ``values`` in ``ixarr`` (kind 'all' -> all True)."""
    if ixarr is None:
        return np.ones(len(values), bool)
    return _in_sorted(values, np.unique(ixarr))


def sparse_extract(sp, rows_ix, cols_ix):
    """C = A[I, J] over sparse storage -> SparseMatrixData (no densify).

    ``rows_ix``/``cols_ix`` are _DimIndex of kind 'array' or 'all'; duplicate
    indices replicate entries like the reference."""
    rarr = _ix_arr(rows_ix)
    carr = _ix_arr(cols_ix)
    nr = rows_ix.size
    nc = cols_ix.size
    rows, cols, vals = sp.rows, sp.cols, sp.vals
    if rarr is not None:
        sel, out_r = _join_positions(rows, rarr)
        rows, cols, vals = out_r, cols[sel], vals[sel]
    if carr is not None:
        sel, out_c = _join_positions(cols, carr)
        rows, cols, vals = rows[sel], out_c, vals[sel]
    return SparseMatrixData.from_arrays(rows, cols, vals, nr, nc, dup_op="second")


def sparse_extract_row(sp, r, cols_ix):
    """w = A[r, J] -> SparseVectorData."""
    lo = np.searchsorted(sp.rows, r, "left")
    hi = np.searchsorted(sp.rows, r, "right")
    cols, vals = sp.cols[lo:hi], sp.vals[lo:hi]
    carr = _ix_arr(cols_ix)
    if carr is None:
        return SparseVectorData(cols.copy(), vals.copy(), cols_ix.size)
    sel, out_c = _join_positions(cols, carr)
    order = np.argsort(out_c, kind="stable")
    return SparseVectorData(out_c[order], vals[sel][order], cols_ix.size)


def sparse_extract_col(sp, c, rows_ix):
    """w = A[I, c] -> SparseVectorData."""
    order_c = sp.col_order()
    cols_sorted = sp.cols[order_c]
    lo = np.searchsorted(cols_sorted, c, "left")
    hi = np.searchsorted(cols_sorted, c, "right")
    rows = sp.rows[order_c][lo:hi]
    vals = sp.vals[order_c][lo:hi]
    rarr = _ix_arr(rows_ix)
    if rarr is None:
        ro = np.argsort(rows, kind="stable")
        return SparseVectorData(rows[ro], vals[ro], rows_ix.size)
    sel, out_r = _join_positions(rows, rarr)
    ro = np.argsort(out_r, kind="stable")
    return SparseVectorData(out_r[ro], vals[sel][ro], rows_ix.size)


def sparse_vec_extract(sv, ix):
    """w = v[I] -> SparseVectorData."""
    iarr = _ix_arr(ix)
    if iarr is None:
        return sv.copy(vals=sv.vals.copy())
    sel, out_i = _join_positions(sv.idx, iarr)
    order = np.argsort(out_i, kind="stable")
    return SparseVectorData(out_i[order], sv.vals[sel][order], ix.size)


_SCALAR_FILL_LIMIT = 1 << 26  # scalar assign materializes the region pattern


def _region_cells(ix_list):
    cells = 1
    for ix in ix_list:
        cells *= 1 if ix.kind == "int" else ix.size
    return cells


def _dedup_last(keys_r, keys_c, vals):
    """Keep the LAST occurrence per (r, c) (duplicate assign indices)."""
    order = np.lexsort((np.arange(len(keys_r)), keys_c, keys_r))
    kr, kc, kv = keys_r[order], keys_c[order], vals[order]
    is_last = np.concatenate([(kr[1:] != kr[:-1]) | (kc[1:] != kc[:-1]), [True]])
    return kr[is_last], kc[is_last], kv[is_last]


def _np_accum(accum, a, b):
    """Host accumulate of region intersections through the typed op."""
    if len(a) == 0:
        return a
    import jax.numpy as jnp

    r = accum.fn(jnp.asarray(a), jnp.asarray(b.astype(a.dtype)))
    return np.asarray(r).astype(a.dtype)


def sparse_assign(sp, ix_list, new_r, new_c, new_v, accum, np_dtype):
    """Region assign on sparse matrix COO (unmasked GrB_assign semantics):
    region entries of C are replaced by the new entries (accum=None) or
    union-merged via accum.  Returns a new SparseMatrixData."""
    rarr = _ix_arr(ix_list[0]) if ix_list[0].kind != "int" else np.asarray([ix_list[0].index], np.int64)
    carr = _ix_arr(ix_list[1]) if ix_list[1].kind != "int" else np.asarray([ix_list[1].index], np.int64)
    in_region = _in_index(sp.rows, rarr) & _in_index(sp.cols, carr)
    keep = ~in_region
    new_v = new_v.astype(np_dtype, copy=False)
    new_r, new_c, new_v = _dedup_last(new_r, new_c, new_v)
    if accum is not None and in_region.any():
        # union-merge: C-region entries combine with new entries on intersection
        cr, cc, cv = sp.rows[in_region], sp.cols[in_region], sp.vals[in_region]
        ka = _pair_keys(cr, cc)
        kb = _pair_keys(new_r, new_c)
        pos = np.searchsorted(kb, ka)
        pos_c = np.minimum(pos, max(len(kb) - 1, 0))
        both_a = (len(kb) > 0) & (pos < len(kb))
        if len(kb):
            both_a &= kb[pos_c] == ka
        ia = np.flatnonzero(both_a)
        ib = pos[ia] if len(ia) else np.zeros(0, np.int64)
        acc_v = _np_accum(accum, cv[ia].astype(np_dtype), new_v[ib])
        only_new = np.ones(len(new_r), bool)
        only_new[ib] = False
        keep_c = np.ones(len(cr), bool)
        keep_c[ia] = False
        merged_r = np.concatenate([cr[ia], cr[keep_c], new_r[only_new]])
        merged_c = np.concatenate([cc[ia], cc[keep_c], new_c[only_new]])
        merged_v = np.concatenate([acc_v, cv[keep_c].astype(np_dtype), new_v[only_new]])
        new_r, new_c, new_v = merged_r, merged_c, merged_v
    rows = np.concatenate([sp.rows[keep], new_r])
    cols = np.concatenate([sp.cols[keep], new_c])
    vals = np.concatenate([sp.vals[keep].astype(np_dtype, copy=False), new_v])
    return SparseMatrixData.from_arrays(rows, cols, vals, sp.nrows, sp.ncols, dup_op="second")


def sparse_vec_assign(sv, ix, new_i, new_v, accum, np_dtype):
    """Region assign on sparse vector (unmasked GrB_assign semantics)."""
    iarr = _ix_arr(ix) if ix.kind != "int" else np.asarray([ix.index], np.int64)
    in_region = _in_index(sv.idx, iarr)
    keep = ~in_region
    new_v = new_v.astype(np_dtype, copy=False)
    new_i, _, new_v = _dedup_last(new_i, np.zeros_like(new_i), new_v)
    if accum is not None and in_region.any():
        ci, cv = sv.idx[in_region], sv.vals[in_region]
        pos = np.searchsorted(new_i, ci)
        pos_c = np.minimum(pos, max(len(new_i) - 1, 0))
        both = (len(new_i) > 0) & (pos < len(new_i))
        if len(new_i):
            both &= new_i[pos_c] == ci
        ia = np.flatnonzero(both)
        ib = pos[ia] if len(ia) else np.zeros(0, np.int64)
        acc_v = _np_accum(accum, cv[ia].astype(np_dtype), new_v[ib])
        only_new = np.ones(len(new_i), bool)
        only_new[ib] = False
        keep_c = np.ones(len(ci), bool)
        keep_c[ia] = False
        new_i2 = np.concatenate([ci[ia], ci[keep_c], new_i[only_new]])
        new_v2 = np.concatenate([acc_v, cv[keep_c].astype(np_dtype), new_v[only_new]])
        new_i, new_v = new_i2, new_v2
    idx = np.concatenate([sv.idx[keep], new_i])
    vals = np.concatenate([sv.vals[keep].astype(np_dtype, copy=False), new_v])
    order = np.argsort(idx, kind="stable")
    return SparseVectorData(idx[order], vals[order], sv.size)


def sparse_delete_region(sp, ix_list):
    """del C[I, J] on sparse matrix storage."""
    rarr = _ix_arr(ix_list[0]) if ix_list[0].kind != "int" else np.asarray([ix_list[0].index], np.int64)
    carr = _ix_arr(ix_list[1]) if ix_list[1].kind != "int" else np.asarray([ix_list[1].index], np.int64)
    keep = ~(_in_index(sp.rows, rarr) & _in_index(sp.cols, carr))
    return SparseMatrixData(sp.rows[keep], sp.cols[keep], sp.vals[keep], sp.nrows, sp.ncols)


def sparse_vec_delete_region(sv, ix):
    iarr = _ix_arr(ix) if ix.kind != "int" else np.asarray([ix.index], np.int64)
    keep = ~_in_index(sv.idx, iarr)
    return SparseVectorData(sv.idx[keep], sv.vals[keep], sv.size)


# ---------------------------------------------------------------------------
# Unmasked sparse x sparse SpGEMM -> sparse output
# Reference: GrB_mxm always produces sparse output (core/matrix.py:2264-2331)
# ---------------------------------------------------------------------------


def _spgemm_flop_limit():
    from ..tx import config as _txconfig

    return int(_txconfig.get("spgemm_flop_limit", 1 << 28))


def sparse_spgemm_full(a_sp, b_sp, sr, out_dtype):
    """C = A (+).(x) B over sparse operands -> SparseMatrixData.

    Host expand-join Gustavson: intermediate products are materialized
    (bounded by tx.config['spgemm_flop_limit']) then grouped by (i, j) and
    reduced with the add monoid.  The masked dot-method plan engine
    (sparse_mxm_masked) remains the performance path; this is the
    semantically-complete unmasked route that never densifies.
    """
    out_np = np.dtype(out_dtype.np_type)
    if a_sp.nvals == 0 or b_sp.nvals == 0:
        return SparseMatrixData(
            np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, out_np),
            a_sp.nrows, b_sp.ncols,
        )
    # per-A-entry B-row ranges via binary search (no nrows-sized indptr:
    # dimensions may be 2^40+)
    lo = np.searchsorted(b_sp.rows, a_sp.cols, "left")
    hi = np.searchsorted(b_sp.rows, a_sp.cols, "right")
    cnt = hi - lo
    total = int(cnt.sum())
    limit = _spgemm_flop_limit()
    if total > limit:
        raise _exc.OutOfMemory(
            f"unmasked sparse mxm would materialize {total} intermediate products "
            f"(> tx.config['spgemm_flop_limit']={limit}); provide a mask "
            "(C(M) << A.mxm(B)) to run the masked dot engine, or raise the limit"
        )
    rep = np.repeat(np.arange(a_sp.nvals), cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    bpos = lo[rep] + offs
    ci = a_sp.rows[rep]
    cj = b_sp.cols[bpos]
    mul = sr.binaryop
    addm = sr.monoid
    pos_mul = mul.positional
    if pos_mul is not None:
        which, delta = pos_mul
        src_idx = {
            "firsti": ci,
            "firstj": a_sp.cols[rep],
            "secondi": b_sp.rows[bpos],
            "secondj": cj,
        }[which]
        prod = (src_idx + delta).astype(out_np)
    else:
        name = mul.parent.name
        av = a_sp.vals[rep]
        bv = b_sp.vals[bpos]
        if name == "times":
            prod = (av.astype(out_np) * bv.astype(out_np))
        elif name == "plus":
            prod = (av.astype(out_np) + bv.astype(out_np))
        elif name == "first":
            prod = av.astype(out_np)
        elif name == "second":
            prod = bv.astype(out_np)
        elif name in ("pair", "oneb"):
            prod = np.ones(total, out_np)
        else:
            import jax.numpy as jnp

            t1 = np.dtype(mul.type_.np_type)
            t2 = np.dtype(mul.type2.np_type)
            prod = np.asarray(
                mul.fn(jnp.asarray(av.astype(t1)), jnp.asarray(bv.astype(t2)))
            ).astype(out_np)
    order = np.lexsort((cj, ci))
    ci, cj, prod = ci[order], cj[order], prod[order]
    starts = np.flatnonzero(
        np.concatenate([[True], (ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])])
    )
    monoid_t = addm if addm.type_.np_type == out_np else _retype_monoid(addm, out_dtype)
    out_v = _np_reduce_groups(prod, starts, addm.parent.name, monoid_t, out_np)
    return SparseMatrixData(ci[starts], cj[starts], out_v, a_sp.nrows, b_sp.ncols)
