"""Loop capture: trace Python functions of DSL statements into ONE XLA program.

The reference's core performance promise is that one user statement is one
fused C call with negligible Python overhead (reference:
docs/user_guide/fundamentals.rst:118-120, docs/getting_started/faq.rst:166-174).
Here the analogous promise is stronger: a whole Python LOOP of DSL
statements can be traced into a single jitted XLA program, so per-statement
dispatch overhead disappears entirely and XLA fuses across statements.

Three entry points:

- ``gb.compile(fn)`` — wrap a function of collections; calls are traced once
  per (shapes, static operands) and replayed as one XLA program.
- ``gb.loop(n_iters, body, *state)`` — run ``body`` (a function of DSL
  statements mapping state collections to state collections) ``n_iters``
  times as ONE ``lax.fori_loop`` program.
- ``gb.until(cond, body, *state)`` — same with a data-dependent stop
  condition (``lax.while_loop``): ``cond(*state)`` returns a boolean Scalar
  (e.g. ``frontier.reduce(monoid.lor)``) or a 0-d device array.

Tracing contract (documented in docs/compile.md): inside a compiled
function, collection VALUES are abstract — host reads (``.nvals``,
``float(s)``, ``repr``) raise ``TracerError``; sparse-format matrices are
closed over as constants (their pattern/plan is fixed at trace time).

Structure hoisting: GraphBLAS algorithms frequently iterate with a
structurally-stable state (PageRank's rank vector is full every iteration).
``loop``/``until`` first try to carry only the VALUES through the loop,
keeping structure bitmaps as trace-time constants; if the body's output
structure is data-dependent (a tracer — e.g. a BFS frontier) or does not
reproduce the input structure exactly, they transparently fall back to
carrying the structure too.  The fast case turns every structure channel
into compile-time constants — the traced SpMV then runs the ``x_full``
plan path, identical work to the hand-written models.
"""

import functools

import numpy as np

from .. import exceptions as _exc


def _is_tracer(x):
    import jax

    return isinstance(x, jax.core.Tracer)


def _commit_leaf(x):
    """Commit a host-side leaf to the device ONCE (device arrays pass
    through).  Besides plain numpy arrays, jax 0.9 binds numpy constants into
    jaxprs as ``TypedNdArray`` host literals (NOT an ndarray subclass) — an
    ``isinstance(np.ndarray)`` check misses them, and every missed leaf is a
    separate host->device re-upload on EVERY execution.
    ``device_put`` preserves the literal's exact dtype and weak_type, so the
    jaxpr's avals still match."""
    import jax
    import jax.numpy as jnp

    if isinstance(x, jax.Array):
        return x
    try:
        from jax._src.literals import TypedNdArray
    except ImportError:  # pragma: no cover - older jax
        TypedNdArray = ()
    if TypedNdArray and isinstance(x, TypedNdArray):
        return jax.device_put(x)
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    return x


# ---------------------------------------------------------------------------
# state flattening: collections <-> leaf arrays
# ---------------------------------------------------------------------------


class _Spec:
    """Static description of one state collection (rebuild recipe)."""

    __slots__ = ("kind", "cls", "dtype", "fields", "name")

    def __init__(self, kind, cls, dtype, fields, name):
        self.kind = kind  # "dense" | "scalar"
        self.cls = cls
        self.dtype = dtype
        self.fields = fields  # UDT field names or None
        self.name = name


def _flatten_one(obj):
    """(leaves, spec) for one collection.  Leaves are device arrays in a
    fixed order: values (or one per UDT field), then struct."""
    import jax.numpy as jnp

    from .matrix import Matrix
    from .scalar import Scalar
    from .vector import Vector

    if isinstance(obj, Scalar):
        if obj.is_empty and not _is_tracer(obj._values):
            raise TypeError("cannot carry an empty Scalar through a compiled loop")
        v = obj._device_value()
        if isinstance(v, dict):
            fields = tuple(v)
            return [v[f] for f in fields], _Spec("scalar", Scalar, obj.dtype, fields, obj.name)
        return [v], _Spec("scalar", Scalar, obj.dtype, None, obj.name)
    if isinstance(obj, (Vector, Matrix)):
        if getattr(obj, "_sparse", None) is not None:
            raise TypeError(
                "sparse-format collections cannot be loop state (their pattern is a "
                "trace-time constant); pass them as closed-over operands instead"
            )
        v, s = obj._values, obj._struct
        if isinstance(v, dict):
            fields = tuple(v)
            return [v[f] for f in fields] + [s], _Spec("dense", type(obj), obj.dtype, fields, obj.name)
        return [v, s], _Spec("dense", type(obj), obj.dtype, None, obj.name)
    raise TypeError(f"Unsupported state object for compiled loop: {type(obj)}")


def _rebuild_one(spec, leaves, struct_override=None):
    """Rebuild a collection from leaves (+ optionally a fixed struct)."""
    from .scalar import Scalar

    if spec.kind == "scalar":
        sc = Scalar(spec.dtype, name=spec.name)
        if spec.fields is not None:
            sc._values = {f: leaf for f, leaf in zip(spec.fields, leaves)}
        else:
            sc._values = leaves[0]
        sc._struct = True
        sc._empty = False
        return sc
    if spec.fields is not None:
        values = {f: leaf for f, leaf in zip(spec.fields, leaves[:-1])}
        struct = leaves[-1] if struct_override is None else struct_override
    else:
        values = leaves[0]
        struct = leaves[1] if struct_override is None else struct_override
    return spec.cls._from_arrays(values, struct, spec.dtype, name=spec.name)


def _n_leaves(spec, with_struct=True):
    if spec.kind == "scalar":
        return len(spec.fields) if spec.fields is not None else 1
    n = len(spec.fields) if spec.fields is not None else 1
    return n + (1 if with_struct else 0)


def _flatten_state(objs):
    leaves, specs = [], []
    for o in objs:
        lv, sp = _flatten_one(o)
        leaves.extend(lv)
        specs.append(sp)
    return leaves, specs


def _rebuild_state(specs, leaves, structs=None):
    out, pos = [], 0
    for i, sp in enumerate(specs):
        with_struct = structs is None
        n = _n_leaves(sp, with_struct=with_struct)
        chunk = leaves[pos : pos + n]
        pos += n
        override = None if structs is None or sp.kind == "scalar" else structs[i]
        out.append(_rebuild_one(sp, chunk, struct_override=override))
    return out


def _split_values_structs(objs):
    """(value_leaves, struct_list) — struct_list has one entry per obj
    (None for scalars)."""
    values, structs = [], []
    for o in objs:
        lv, sp = _flatten_one(o)
        if sp.kind == "scalar":
            values.extend(lv)
            structs.append(None)
        else:
            values.extend(lv[:-1])
            structs.append(lv[-1])
    return values, structs


def _value_leaves_of(objs):
    v, _ = _split_values_structs(objs)
    return v


class _StructureDiverged(Exception):
    """Internal: body output structure is data-dependent or not a fixed point."""


# diagnostic: how the last loop/until call carried state ("hoisted" = structure
# bitmaps were trace-time constants; "carried" = structure rode the loop carry)
_LAST_MODE = {"loop": None}


def last_loop_mode():
    return _LAST_MODE["loop"]


def _as_state_tuple(state):
    if len(state) == 1 and isinstance(state[0], (tuple, list)):
        return tuple(state[0])
    return tuple(state)


def _check_body_out(out, specs, where):
    out = out if isinstance(out, (tuple, list)) else (out,)
    if len(out) != len(specs):
        raise TypeError(
            f"{where} must return the same number of state collections it was given "
            f"({len(specs)}); got {len(out)}"
        )
    return tuple(out)


def _cast_like(leaves, ref_leaves):
    """Cast body-output leaves to the carried dtypes (loop state must be
    shape/dtype stable, like lax.fori_loop requires)."""
    import jax.numpy as jnp

    out = []
    for a, r in zip(leaves, ref_leaves):
        a = jnp.asarray(a)
        if a.shape != r.shape:
            raise _exc.DimensionMismatch(
                f"loop body changed a state shape: {a.shape} != {r.shape}"
            )
        out.append(a.astype(r.dtype) if a.dtype != r.dtype else a)
    return out


# ---------------------------------------------------------------------------
# gb.loop / gb.until
# ---------------------------------------------------------------------------


def loop(n_iters, body, *state):
    """Run ``body(*state) -> state`` for ``n_iters`` iterations as ONE jitted
    ``lax.fori_loop`` program.  Returns the final state collections (a single
    collection if one was given).

    ``body`` is an ordinary Python function of DSL statements; its
    collection arguments are rebuilt around abstract values each trace.
    For repeated executions (benchmarks, restarts) use ``loop_runner`` —
    it returns a reusable compiled program instead of retracing per call.
    """
    return loop_runner(n_iters, body, *state)()


def until(cond, body, *state, max_iters=None):
    """Run ``body`` while ``cond(*state)`` is true, as ONE jitted
    ``lax.while_loop`` program.  ``cond`` returns a boolean Scalar (e.g.
    ``frontier.reduce(monoid.lor)``), a boolean expression, or a 0-d array.
    ``max_iters`` optionally bounds the iteration count."""
    return until_runner(cond, body, *state, max_iters=max_iters)()


def loop_runner(n_iters, body, *state):
    """Compile ``body`` over ``state`` once; returns a ``CompiledLoop``."""
    state = _as_state_tuple(state)
    leaves, specs = _flatten_state(state)
    return CompiledLoop("fori", body, specs, leaves, len(state) == 1, n_iters=int(n_iters))


def until_runner(cond, body, *state, max_iters=None, unroll=1):
    """Compile ``body``-until-``cond`` once; returns a ``CompiledLoop``.

    ``unroll=K`` runs K body steps per while iteration, checking ``cond``
    every K steps.  Valid ONLY for fixpoint bodies (extra steps past
    convergence are no-ops — BFS/SSSP/CC-style min/max accumulators): the
    loop may run up to K-1 extra body steps.  Amortizes the per-iteration
    cond/while overhead; ``last_iters`` counts body steps (a multiple of K).
    """
    state = _as_state_tuple(state)
    leaves, specs = _flatten_state(state)
    return CompiledLoop(
        "while", body, specs, leaves, len(state) == 1, cond=cond,
        max_iters=max_iters, unroll=int(unroll),
    )


def _hoist_constants(fn, example_args):
    """Trace ``fn`` to a jaxpr and hoist ALL its constants into arguments.

    jax.closure_convert only hoists potentially-perturbed (differentiable)
    consts; outside autodiff everything stays closed over and becomes an HLO
    literal — a scale-19 graph's plan tables are hundreds of MB, which
    overflows remote-compile transports.  Returns (converted_fn, consts)
    with converted_fn(args, consts) re-evaluating the jaxpr.
    """
    import jax
    from jax._src import core as _jcore

    flat, in_tree = jax.tree_util.tree_flatten(example_args)
    store = {}

    def flat_fn(*fl):
        a = jax.tree_util.tree_unflatten(in_tree, fl)
        out = fn(*a)
        of, ot = jax.tree_util.tree_flatten(out)
        store["out_tree"] = ot
        return of

    closed = jax.make_jaxpr(flat_fn)(*flat)
    # commit every const to the device ONCE: jaxpr consts can include
    # host-numpy structure bitmaps (kept numpy by design for hoisting) and
    # TypedNdArray literals; any host leaf passed to jit re-uploads per call
    consts = tuple(_commit_leaf(c) for c in closed.consts)

    def converted(args, consts_):
        fl, in_tree2 = jax.tree_util.tree_flatten((args,))
        if in_tree2 != in_tree:
            raise TypeError("compiled loop called with a different state structure")
        outs = _jcore.eval_jaxpr(closed.jaxpr, list(consts_), *fl)
        return jax.tree_util.tree_unflatten(store["out_tree"], outs)

    return converted, consts


class CompiledLoop:
    """A reusable compiled DSL loop (ONE XLA program).

    ``runner()`` executes from the captured initial state; ``runner(*state)``
    runs from new state collections with the same shapes/dtypes.  In hoisted
    mode the structure bitmaps are compile-time constants, so new inputs must
    carry identical structure (validated host-side).
    """

    def __init__(self, kind, body, specs, leaves, single, *, n_iters=None, cond=None, max_iters=None, unroll=1):
        import jax

        self._kind = kind
        self._body = body
        self._specs = specs
        self._leaves0 = list(leaves)
        self._single = single
        self._n_iters = n_iters
        self._cond = cond
        self._max_iters = max_iters
        self._unroll = max(1, int(unroll))
        self.mode = None
        self.layout = "n"  # "edge" when the edge-layout lowering applied
        self.last_iters = None  # while-loops: iteration count of the last run
        self._jit = None
        self._consts = ()
        self._structs = None
        self._edge = None  # (ctx, device slot table) in edge layout
        self._build()
        # post-build: commit initial-state leaves to the device once (host
        # leaves would re-upload per call — see _hoist_constants note)
        self._leaves0 = [_commit_leaf(l) for l in self._leaves0]
        if self.mode == "hoisted":
            self._values0 = [_commit_leaf(v) for v in self._values0]
        _LAST_MODE["loop"] = self.mode

    # -- build --------------------------------------------------------------

    def _cond_value(self, st):
        import jax.numpy as jnp

        from .base import BaseExpression
        from .scalar import Scalar

        c = self._cond(*st)
        if isinstance(c, BaseExpression):
            c = c.new()
        if isinstance(c, Scalar):
            c = c._device_value()
        return jnp.asarray(c, bool).reshape(())

    def _wrap(self, kind, lbody, lcond=None):
        import jax.numpy as jnp
        from jax import lax

        if kind == "fori":
            def run(vals):
                return lax.fori_loop(0, self._n_iters, lambda i, v: lbody(v), tuple(vals))

            return run

        def run(vals):
            it0 = jnp.zeros((), jnp.int32)
            k = self._unroll

            def wcond(carry):
                vals_c, it = carry
                ok = lcond(vals_c)
                if self._max_iters is not None:
                    ok = ok & (it < self._max_iters)
                return ok

            def wbody(carry):
                vals_c, it = carry
                for _ in range(k):  # unroll: cond checked every k body steps
                    vals_c = lbody(vals_c)
                return vals_c, it + k

            final, it = lax.while_loop(wcond, wbody, (tuple(vals), it0))
            return final, it

        return run

    def _build(self):
        import jax

        specs, body = self._specs, self._body
        # -- attempt 1: values-only carry; structure hoisted to constants ---
        values0, structs0 = _split_values_structs(_rebuild_state(specs, self._leaves0))
        captured = list(structs0)

        def lbody_hoisted(vals):
            st = _rebuild_state(specs, list(vals), structs=captured)
            out = _check_body_out(body(*st), specs, "loop body")
            out_values, out_structs = _split_values_structs(out)
            for s_in, s_out in zip(captured, out_structs):
                if s_in is None:
                    continue
                if _is_tracer(s_out) or not np.array_equal(np.asarray(s_in), np.asarray(s_out)):
                    raise _StructureDiverged
            return tuple(_cast_like(out_values, list(vals)))

        def lcond_hoisted(vals):
            st = _rebuild_state(specs, list(vals), structs=captured)
            return self._cond_value(st)

        run_h = self._wrap(self._kind, lbody_hoisted, lcond_hoisted if self._kind == "while" else None)
        from . import looplayout as _ll

        probe = _ll._ProbeScope() if self._edge_layout_enabled() else None
        try:
            # hoist captured device arrays (graph plans, operand vectors)
            # into ARGUMENTS — as closed-over constants they would embed in
            # the HLO as literals (hundreds of MB for a scale-19 graph).
            # The probe records every plan-engine SpMV dispatch so the
            # edge-layout upgrade below knows its eligibility.
            if probe is not None:
                with probe:
                    conv, consts = _hoist_constants(run_h, (tuple(values0),))
            else:
                conv, consts = _hoist_constants(run_h, (tuple(values0),))
        except _StructureDiverged:
            conv = None
        if conv is not None:
            import jax.numpy as jnp

            if probe is not None and self._try_edge_layout(probe, values0, captured):
                # edge-layout lowering succeeded: 2 permutation networks per
                # SpMV instead of 3 (core/looplayout.py) — model-speed loops
                return
            self.mode = "hoisted"
            self._jit = jax.jit(conv)
            self._consts = consts
            self._structs = captured
            # commit the captured structure bitmaps to the device ONCE —
            # re-uploading them per call is a host->device copy per run
            self._structs_dev = [
                None if s is None else _commit_leaf(np.asarray(s)) for s in captured
            ]
            self._values0 = values0
            return

        # -- fallback: carry structure through the loop ---------------------
        def lbody_full(vals):
            st = _rebuild_state(specs, list(vals))
            out = _check_body_out(body(*st), specs, "loop body")
            out_leaves, _ = _flatten_state(out)
            return tuple(_cast_like(out_leaves, list(vals)))

        def lcond_full(vals):
            st = _rebuild_state(specs, list(vals))
            return self._cond_value(st)

        run_f = self._wrap(self._kind, lbody_full, lcond_full if self._kind == "while" else None)
        self.mode = "carried"
        conv, consts = _hoist_constants(run_f, (tuple(self._leaves0),))
        self._jit = jax.jit(conv)
        self._consts = consts

    # -- edge-layout upgrade (core/looplayout.py) -----------------------------

    @staticmethod
    def _edge_layout_enabled():
        import os

        if os.environ.get("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", "1") != "1":
            return False
        from .sparse import _mxv_strategy, uses_plan_engine

        # edge layout is a plan-engine feature: same rule as eager mxv
        return uses_plan_engine(_mxv_strategy())

    def _try_edge_layout(self, probe, values0, structs0):
        """Re-trace the body with state carried in the EDGE layout (values at
        dst-seg-last slots of a total plan): every SpMV routes through the
        composed loop network — 2 permutation networks instead of 3.  Any
        failure keeps the n-space hoisted build; the upgrade is strictly
        performance-only (same results bit-for-bit for the supported ops)."""
        import jax

        from . import looplayout as _ll
        from .vector import Vector

        elig = probe.eligible()
        if elig is None:
            return False
        sp, pull = elig
        specs = self._specs
        for spec, s in zip(specs, structs0):
            if spec.kind == "scalar":
                continue
            if spec.cls is not Vector or spec.fields is not None:
                return False
            if _is_tracer(s):
                return False
        try:
            plan = sp.plan("pull" if pull else "push", loop=True)
            ctx = _ll.EdgeLayoutCtx(sp, plan, pull)
        except Exception:
            return False
        # all dense state must be n-sized (the virtual vertex space)
        for spec, s in zip(specs, structs0):
            if spec.kind != "scalar" and np.asarray(s).shape != (ctx.n,):
                return False

        # -- convert the initial state (host-side; leaves are concrete) -----
        edge_values0, edge_structs, pos = [], [], 0
        for spec, s in zip(specs, structs0):
            if spec.kind == "scalar":
                for _ in range(_n_leaves(spec)):
                    edge_values0.append(values0[pos])
                    pos += 1
                edge_structs.append(None)
                continue
            v = values0[pos]
            pos += 1
            if _is_tracer(v):
                return False
            es = ctx.lift_struct_np(np.asarray(s))
            ev = ctx.lift_values_np(np.asarray(v)).copy()
            ev[~es] = 0  # canonical: values outside the pattern are zero
            edge_values0.append(ev)
            edge_structs.append(es)

        captured_e = list(edge_structs)

        def lbody_edge(vals):
            st = _rebuild_state(specs, list(vals), structs=captured_e)
            with ctx:
                out = _check_body_out(self._body(*st), specs, "loop body")
            out_values, out_structs = _split_values_structs(out)
            for s_in, s_out in zip(captured_e, out_structs):
                if s_in is None:
                    continue
                if _is_tracer(s_out) or not np.array_equal(np.asarray(s_in), np.asarray(s_out)):
                    raise _StructureDiverged
            return tuple(_cast_like(out_values, list(vals)))

        def lcond_edge(vals):
            st = _rebuild_state(specs, list(vals), structs=captured_e)
            with ctx:
                return self._cond_value(st)

        run_core = self._wrap(
            self._kind, lbody_edge, lcond_edge if self._kind == "while" else None
        )

        def run_edge(vals):
            out = run_core(vals)
            if self._kind == "while":
                final, it = out
            else:
                final = out
            # exit: lower each vector's values back to the vertex space (one
            # collect network per state vector, once per EXECUTION)
            lowered, p = [], 0
            for spec in specs:
                if spec.kind == "scalar":
                    for _ in range(_n_leaves(spec)):
                        lowered.append(final[p])
                        p += 1
                else:
                    lowered.append(_ll.state_to_n_total(plan, final[p]))
                    p += 1
            return (tuple(lowered), it) if self._kind == "while" else tuple(lowered)

        try:
            conv, consts = _hoist_constants(run_edge, (tuple(edge_values0),))
        except Exception:
            # anything the layout can't express (LayoutUnsupported, shape
            # mismatches, structure divergence): keep the n-space build
            return False
        self.mode = "hoisted"
        self.layout = "edge"
        self._jit = jax.jit(conv)
        self._consts = consts
        # rebuild/validation still speak the ORIGINAL n-space structures
        self._structs = structs0
        self._structs_dev = [
            None if s is None else _commit_leaf(np.asarray(s)) for s in structs0
        ]
        self._values0 = edge_values0
        self._edge = (ctx, _commit_leaf(ctx.slot_of_v.astype(np.int32)))
        return True

    def _edge_lift_values(self, values, structs):
        """Device-side n->edge conversion for runner(*new_state) calls."""
        import jax.numpy as jnp

        ctx, slots = self._edge
        out, p = [], 0
        for spec, s in zip(self._specs, structs):
            if spec.kind == "scalar":
                for _ in range(_n_leaves(spec)):
                    out.append(values[p])
                    p += 1
                continue
            v = values[p]
            p += 1
            ev = jnp.zeros((ctx.e_pad,), v.dtype).at[slots].set(v)
            out.append(ev)
        return out

    # -- execute ------------------------------------------------------------

    def __call__(self, *state):
        import jax.numpy as jnp

        specs = self._specs
        if state:
            state = _as_state_tuple(state)
            leaves, new_specs = _flatten_state(state)
            if len(new_specs) != len(specs):
                raise TypeError("runner called with a different number of state collections")
        else:
            leaves = self._leaves0

        if self.mode == "hoisted":
            if state:
                values, structs = _split_values_structs(_rebuild_state(specs, leaves))
                for s_new, s_cap in zip(structs, self._structs):
                    if s_cap is None:
                        continue
                    if not np.array_equal(np.asarray(s_new), np.asarray(s_cap)):
                        raise ValueError(
                            "compiled loop was specialized to a fixed structure; "
                            "input structure differs — rebuild with loop_runner"
                        )
                if self.layout == "edge":
                    values = self._edge_lift_values(values, structs)
            else:
                values = self._values0
            final_values = self._jit(tuple(values), self._consts)
            if self._kind == "while":
                final_values, it = final_values
                self.last_iters = it
            out_leaves, pos = [], 0
            for i, sp in enumerate(specs):
                n = _n_leaves(sp, with_struct=False)
                out_leaves.extend(final_values[pos : pos + n])
                pos += n
                if sp.kind != "scalar":
                    out_leaves.append(self._structs_dev[i])
            out = _rebuild_state(specs, out_leaves)
        else:
            final = self._jit(tuple(leaves), self._consts)
            if self._kind == "while":
                final, it = final
                self.last_iters = it
            out = _rebuild_state(specs, list(final))
        return out[0] if self._single else tuple(out)


# ---------------------------------------------------------------------------
# gb.compile
# ---------------------------------------------------------------------------


def compile(fn=None):
    """Wrap ``fn`` so each call traces once into a single jitted XLA program.

    Collection arguments (dense Matrix/Vector, non-empty Scalar) become
    traced inputs; sparse-format matrices and non-collection arguments are
    treated as static (part of the trace cache key, captured by identity).
    The function may return collections, tuples of collections, or plain
    arrays.  Python loops inside ``fn`` unroll; use ``gb.loop``/``gb.until``
    for compiled iteration.
    """
    if fn is None:
        return compile

    import jax

    from .base import BaseType
    from .matrix import Matrix
    from .scalar import Scalar
    from .vector import Vector

    cache = {}

    def _is_traced_arg(a):
        if isinstance(a, (Vector, Matrix)) and getattr(a, "_sparse", None) is None:
            return True
        if isinstance(a, Scalar) and not a.is_empty:
            return True
        return False

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        traced_idx = tuple(i for i, a in enumerate(args) if _is_traced_arg(a))
        static_parts = tuple(
            (i, id(a)) if isinstance(a, BaseType) or not _hashable(a) else (i, a)
            for i, a in enumerate(args)
            if i not in traced_idx
        )
        if kwargs:
            static_parts = static_parts + tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))
        traced_objs = [args[i] for i in traced_idx]
        leaves, specs = _flatten_state(traced_objs)
        shapes = tuple((tuple(l.shape), str(np.dtype(l.dtype))) for l in leaves)
        key = (traced_idx, static_parts, shapes)

        entry = cache.get(key)
        if entry is None:
            out_spec_cell = {}

            def run(leaf_args):
                objs = _rebuild_state(specs, list(leaf_args))
                full_args = list(args)
                for obj, i in zip(objs, traced_idx):
                    full_args[i] = obj
                result = fn(*full_args, **kwargs)
                flat, layout = _flatten_result(result)
                out_spec_cell["layout"] = layout
                return tuple(flat)

            # captured arrays (sparse plans, static operands) become jit
            # ARGUMENTS, not HLO constants (see _hoist_constants)
            conv, consts = _hoist_constants(run, (tuple(leaves),))
            entry = (jax.jit(conv), consts, out_spec_cell)
            cache[key] = entry
        run, consts, out_spec_cell = entry
        out_leaves = run(tuple(leaves), consts)
        return _rebuild_result(out_spec_cell["layout"], list(out_leaves))

    wrapper._cache = cache
    return wrapper


def _hashable(x):
    try:
        hash(x)
    except TypeError:
        return False
    return True


def _flatten_result(result):
    """Flatten fn outputs (collections / tuples / arrays) to leaves + layout."""
    import jax.numpy as jnp

    from .base import BaseType

    if isinstance(result, (tuple, list)):
        flat, layouts = [], []
        for r in result:
            f, l = _flatten_result(r)
            flat.extend(f)
            layouts.append((len(f), l))
        return flat, ("tuple", type(result), layouts)
    if isinstance(result, BaseType):
        lv, sp = _flatten_one(result)
        return lv, ("collection", sp)
    return [jnp.asarray(result)], ("array", None)


def _rebuild_result(layout, leaves):
    kind = layout[0]
    if kind == "tuple":
        _, cls, layouts = layout
        out, pos = [], 0
        for n, l in layouts:
            out.append(_rebuild_result(l, leaves[pos : pos + n]))
            pos += n
        return cls(out)
    if kind == "collection":
        sp = layout[1]
        return _rebuild_one(sp, leaves)
    return leaves[0]
