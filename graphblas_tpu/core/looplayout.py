"""Edge-layout ("loop layout") lowering context for compiled DSL loops.

The n-space plan SpMV pays THREE 11-stage permutation networks per pass
(place, perm, collect — ops/fastspmv.py); iterative algorithms only need TWO
when the state lives in the edge space at dst-seg-last slots (the v3 loop
layout the hand-written models use, ops/fastspmv.py).  This module lets
``gb.loop``/``gb.until`` (core/compiler.py) trace a USER-WRITTEN DSL body in
that layout, closing the DSL-vs-model gap without any model-specific code:

- Every state Vector of size n is carried as an e_pad array whose vertex v
  value lives at v's dst-seg-last slot ("state slot").  This requires a
  TOTAL plan (build_spmv_plan(total=True)): one invalid pad edge per
  in-degree-0 vertex so every vertex owns a state slot.
- Elementwise ops / apply / masked merges are slot-wise and need no changes.
- Structure invariant: every in-context structure is a subset of the state
  slots (``is_last``), so reduces over struct are exact; complemented masks
  are re-universed to the state slots (Mask._bits).
- ``A.mxv(x)`` against the context matrix routes the state through the
  composed loop network + fill + perm + one fused reduce: 2 networks/SpMV.
- Anything the layout cannot represent (positional ops, non-full-slice
  indexing, a second matrix/direction, sparse/partial SpMV inputs) raises
  ``LayoutUnsupported``; the compiler falls back to the n-space lowering,
  so the transform is performance-only — never semantics-affecting.

The reference has no analogue (SuiteSparse fuses per statement, not across
statements); this extends its "1 statement = 1 fused call" promise
(reference docs/user_guide/fundamentals.rst:118-120) to one loop = one
program.  The layout is a plan-engine feature: it engages only under
``mxv_strategy="plan"`` (core/sparse.uses_plan_engine).
"""

import contextvars

import numpy as np

_CTX = contextvars.ContextVar("gbtpu-looplayout", default=None)
_PROBE = contextvars.ContextVar("gbtpu-looplayout-probe", default=None)


class LayoutUnsupported(Exception):
    """Internal: the DSL body used an op the edge layout cannot express."""


def active():
    return _CTX.get()


def probing():
    return _PROBE.get()


class _ProbeScope:
    """Records every plan-eligible mxv/vxm dispatch during a throwaway trace
    (no plans are built): the compiler uses the record to decide whether the
    edge-layout attempt can apply and which matrix/direction it binds."""

    def __init__(self):
        self.calls = []
        self.tokens = None

    def __enter__(self):
        self.token = _PROBE.set(self)
        return self

    def __exit__(self, *exc):
        _PROBE.reset(self.token)
        return False

    def record(self, sp, pull, a_first, sr):
        self.calls.append(
            {"sp": sp, "pull": bool(pull), "a_first": bool(a_first), "sr": sr}
        )

    def eligible(self):
        """The single (sparse-matrix, direction) every SpMV used, or None."""
        if not self.calls:
            return None
        keys = {(id(c["sp"]), c["pull"]) for c in self.calls}
        if len(keys) != 1:
            return None
        c = self.calls[0]
        return c["sp"], c["pull"]


class EdgeLayoutCtx:
    """Active while the compiler traces a DSL body in the edge layout."""

    def __init__(self, sp, plan, pull):
        from ..ops import fastspmv as _fs

        if not plan.total or plan.loop_plan is None:
            raise LayoutUnsupported("plan is not total/loop-capable")
        if plan.e_pad == plan.n:
            # size-based layout detection would be ambiguous
            raise LayoutUnsupported("e_pad == n")
        self.sp = sp
        self.plan = plan
        self.pull = pull
        self.n = plan.n
        self.e_pad = plan.e_pad
        h = _fs.host_tables(plan)
        self.v_of_slot = h["v_of_slot"]
        self.is_last = h["is_last"]
        self.slot_of_v = h["slot_of_v"]
        self.dst_nonempty = h["dst_nonempty"]
        self._cache = {}
        self._token = None

    # -- scope ---------------------------------------------------------------

    def __enter__(self):
        self._token = _CTX.set(self)
        return self

    def __exit__(self, *exc):
        _CTX.reset(self._token)
        return False

    # -- layout predicates ----------------------------------------------------

    def is_state_sized(self, obj):
        return getattr(obj, "ndim", None) == 1 and obj.shape[0] == self.e_pad

    def is_n_sized(self, obj):
        return getattr(obj, "ndim", None) == 1 and obj.shape[0] == self.n

    # -- conversions (host-side numpy; used at trace/build time) --------------

    def lift_values_np(self, x_n):
        """n-vector values -> edge layout (vertex-constant per dst segment)."""
        return np.asarray(x_n)[self.v_of_slot]

    def lift_struct_np(self, s_n):
        """n structure -> edge layout, masked to the state-slot universe."""
        return np.asarray(s_n)[self.v_of_slot] & self.is_last

    def lower_struct_np(self, s_e):
        return np.asarray(s_e)[self.slot_of_v]

    def guard_universe_np(self, bits):
        """Structures/mask bits in-context may never mark non-state slots
        (a complemented mask would otherwise resurrect garbage slots)."""
        if isinstance(bits, np.ndarray):
            return bits & self.is_last
        import jax.numpy as jnp

        return bits & jnp.asarray(self.is_last)

    # -- vector lift (trace-time) ----------------------------------------------

    def lift_vector(self, vec):
        """Concrete n-sized Vector operand -> an e_pad edge-layout Vector.

        Values must be host-readable (closed-over operands are concrete
        during the body trace; loop-carried tracers never need lifting —
        they are e_pad-sized by construction)."""
        import jax

        from .vector import Vector

        # _values/_struct access densifies sparse-backed vectors (guarded by
        # tx.config['densify_limit'] — past the limit the densify raises and
        # the compiler falls back to the n-space lowering)
        v, s = vec._values, vec._struct
        if isinstance(v, dict):
            raise LayoutUnsupported("UDT operand lift")
        if isinstance(v, jax.core.Tracer) or isinstance(s, jax.core.Tracer):
            raise LayoutUnsupported("abstract n-sized operand in edge-layout body")
        sv = self.lift_values_np(np.asarray(v)).copy()
        ss = self.lift_struct_np(np.asarray(s))
        sv[~ss] = 0
        return Vector._from_arrays(sv, ss, vec.dtype, name=vec.name)

    @property
    def ys_nonempty(self):
        """Edge-layout structure of an SpMV output for a FULL input: present
        exactly at state slots of vertices with >=1 valid in-edge."""
        ys = self._cache.get("ys_nonempty")
        if ys is None:
            ys = self.is_last & self.dst_nonempty[self.v_of_slot]
            self._cache["ys_nonempty"] = ys
        return ys


# ---------------------------------------------------------------------------
# the edge-layout SpMV (2 networks: loop_net + perm; one fused reduce)
# ---------------------------------------------------------------------------

_EDGE_ADDS = {"plus", "min", "max", "any"}
_EDGE_MULS = {"times", "plus", "first", "second"}


def edge_mxv(ctx, sp, pull, a_first, xv, xs, sr, out_dtype):
    """Loop-layout SpMV on edge-layout state ``xv`` (values at state slots).

    Returns (values e_pad, struct numpy e_pad).  Raises LayoutUnsupported for
    anything the layout cannot express — the compiler then falls back to the
    n-space lowering for the whole loop.
    """
    import jax
    import jax.numpy as jnp

    from ..ops import fastspmv as _fs
    from ..ops.permute import apply_plan
    from .sparse import _plan_mul_name

    if sp is not ctx.sp:
        raise LayoutUnsupported("SpMV against a second matrix in an edge-layout loop")
    if bool(pull) != ctx.pull:
        raise LayoutUnsupported("SpMV in both directions in an edge-layout loop")
    mul = sr.binaryop
    add_name = sr.monoid.parent.name
    if mul.positional is not None:
        raise LayoutUnsupported("positional semiring in edge layout")
    plan_mul = _plan_mul_name(mul, a_first, None)
    if add_name not in _EDGE_ADDS or plan_mul not in _EDGE_MULS:
        raise LayoutUnsupported(f"semiring {sr.name} has no edge-layout channel")
    out_np = np.dtype(out_dtype.np_type)
    channel = _edge_channel(out_np, add_name)
    if channel is None:
        raise LayoutUnsupported(f"no exact edge-layout channel for {out_np}")
    if isinstance(xs, jax.core.Tracer):
        raise LayoutUnsupported("data-dependent SpMV input structure")
    xs_np = np.asarray(xs)
    if not (xs_np | ~ctx.is_last).all():
        # partial input: the scan would need a routed structure channel
        raise LayoutUnsupported("partial (non-full) SpMV input in edge layout")

    plan = sp.plan("pull" if pull else "push", loop=True)
    if plan is not ctx.plan:  # pragma: no cover - plan replaced mid-trace
        raise LayoutUnsupported("plan changed between probe and edge trace")
    wrap = None
    if channel == np.int32 and out_np.kind in "iu" and out_np.itemsize < 4:
        wrap = (out_np.itemsize * 8, out_np.kind == "i")
    ch = jnp.int32 if channel == np.int32 else jnp.float32

    x_start = apply_plan(xv.astype(ch), plan.loop_plan)  # state -> start slots
    xe = _fs._seg_fill(plan, x_start)
    xe_dst = apply_plan(xe, plan.perm_plan)
    w = plan.w_dst_order if plan_mul in ("times", "plus", "second") else None
    op_add = {"plus": "add", "min": "min", "max": "max", "any": "max"}[add_name]
    scanned = _fs._reduce_dst(plan, xe_dst, w, plan.valid_dst_order, op_add, plan_mul, wrap=wrap)
    ys = ctx.ys_nonempty
    yv = jnp.where(jnp.asarray(ys), scanned.astype(out_np), jnp.zeros((), out_np))
    return yv, ys


def _edge_channel(out_np, add_name):
    """Exact engine channel for the edge layout (mirrors sparse._plan_channel
    minus the value-range cases that need concrete inputs — loop state is
    abstract, so 64-bit outputs reject instead of range-checking)."""
    kind = out_np.kind
    if out_np == np.float32:
        return np.float32
    if kind == "b" or (kind in "iu" and out_np.itemsize <= 2) or out_np == np.int32:
        return np.int32
    if out_np == np.uint32:
        # min/max would compare sign-flipped through the int32 channel
        return np.int32 if add_name in ("plus", "any") else None
    return None


# value-only IndexUnaryOp/SelectOp families: exact in any layout (they never
# read the index).  Everything else is index-dependent — slot ids are not
# vertex ids, so the edge layout must reject them.
_VALUE_ONLY_OPS = {
    "valueeq", "valuene", "valuelt", "valuele", "valuegt", "valuege",
}


def reject_index_semantics(obj, op, what):
    """Raise LayoutUnsupported for index-dependent ops on edge-layout state
    (positions in the edge layout are slot ids, not vertex ids)."""
    ctx = _CTX.get()
    if ctx is None or getattr(obj, "ndim", None) != 1:
        return
    if obj.shape[0] != ctx.e_pad:
        return
    name = getattr(getattr(op, "parent", op), "name", None) or getattr(op, "name", "")
    if str(name).split("[")[0] in _VALUE_ONLY_OPS:
        return
    raise LayoutUnsupported(f"{what} ({name}) is index-dependent in the edge layout")


def state_to_n_total(plan, v_state):
    """Exit conversion: edge-layout values -> (n,) through the collect
    network.  Total plans cover every vertex, so no masking is needed."""
    from ..ops.permute import apply_plan

    return apply_plan(v_state, plan.collect_plan)[: plan.n]
