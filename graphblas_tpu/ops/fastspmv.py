"""Permutation-network SpMV: O(E) semiring mxv without XLA gather/scatter.

The pipeline (all static-shape):

    expand:   x (n,) -> x[src] in src-sorted edge order
              = place x at CSR boundaries (a static place network) +
              segmented forward-fill (ops/segscan.py)
    multiply: per-edge semiring multiply with the edge weights
    permute:  src-sorted order -> dst-sorted order via a PermutePlan
              (lane-shuffle/transpose network, ops/permute.py)
    reduce:   sorted segment reduce by dst over static segment ids
              (ops/segscan.py); the collect network reads the totals

Plans and layouts are built once per graph (the pattern analysis step —
the analogue of SuiteSparse choosing Gustavson/hash/dot per matrix) and
reused every iteration.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..native import counting_sort
from .permute import PermutePlan, apply_plan, build_permutation_plan, padded_size


class SpmvPlan:
    """Static layout + routing for y = A^T-style pulls over a fixed graph.

    Computes, for x over sources: y[d] = REDUCE_{edges (s -> d)} x[s] (*) w.
    Registered as a pytree: arrays travel as jit arguments.
    """

    def __init__(
        self,
        n,
        e_pad,
        src_sorted,
        w_dst_order,
        indptr_src,
        indptr_dst,
        perm_plan,
        valid_dst_order,
        src_dst_order=None,
        place_plan=None,
        collect_plan=None,
        seg_start_src=None,
        seg_dst=None,
        dst_nonempty=None,
        loop_plan=None,
        start_has_state=None,
        is_last_dst=None,
        outdeg_start=None,
        last_dangling=None,
        fill_j=None,
        fill_hp=None,
        k_iso_dangling=0,
        loop_donors=False,
        total=False,
    ):
        self.n = n
        self.e_pad = e_pad
        self.src_sorted = src_sorted  # device: src of each edge in src-sorted order (int32)
        self.w_dst_order = w_dst_order  # device: weights in dst-sorted order (or None)
        self.indptr_src = indptr_src  # device (n+1,) int32: src segment boundaries
        self.indptr_dst = indptr_dst  # device (n+1,) int32: dst segment boundaries
        self.perm_plan = perm_plan  # PermutePlan: src-order -> dst-order
        self.valid_dst_order = valid_dst_order  # device bool: real edge (in dst order)
        # static src ids (f32) in dst order: the positional-mul channel
        # (secondi/firstj contributions are the src vertex id — no expand needed)
        self.src_dst_order = src_dst_order
        # -- v2 (gather/scatter-free endpoints) ------------------------------
        # place: network putting x[i] at src-segment-start slots
        self.place_plan = place_plan
        # collect: network bringing each dst segment's last slot to position d
        self.collect_plan = collect_plan
        self.seg_start_src = seg_start_src  # device bool (e_pad,)
        # dst segment id (= dst vertex) of each dst-order slot: the sorted
        # segment ids of the reduce (ops/segscan.segmented_reduce)
        self.seg_dst = seg_dst  # device int32 (e_pad,)
        self.dst_nonempty = dst_nonempty  # device bool (n,): >=1 VALID in-edge
        # -- v3 (iterative "loop layout"): algorithm state lives in the edge
        # space at dst-segment-LAST slots; ONE composed network (loop_plan)
        # routes it straight to src-segment-START slots for the next
        # iteration, replacing the per-iteration collect + place pair
        # (11 of 33 network stages per SpMV saved) --------------------------
        self.loop_plan = loop_plan  # PermutePlan: dst-seg-last -> src-seg-start
        # at src-seg-start slots: does this vertex have a state slot?
        self.start_has_state = start_has_state  # device bool (e_pad,)
        self.is_last_dst = is_last_dst  # device bool (e_pad,): state slots
        # TRUE (valid) out-degree at src-seg-start slots, min-clamped to 1
        self.outdeg_start = outdeg_start  # device f32 (e_pad,)
        # at state slots: vertex has zero valid out-edges (PageRank dangling)
        self.last_dangling = last_dangling  # device bool (e_pad,)
        # dangling vertices WITHOUT a state slot (isolated): their rank is the
        # per-iteration scalar c; static count folds them into dangling mass
        self.k_iso_dangling = k_iso_dangling  # static int
        # static-fill gather index for seg_start_src (segscan.build_fill_tables):
        # the expand fill is one take from the latest flagged slot
        self.fill_j = fill_j  # device int32 (e_pad,)
        self.fill_hp = fill_hp  # device bool (e_pad,)
        # loop_plan routes no-state start slots from identity-valued donor
        # slots (static: x_start = routed, no select) — see build_spmv_plan
        self.loop_donors = loop_donors
        # every vertex owns a state slot (see build_spmv_plan total=True);
        # required by the compiled DSL loop's edge-layout lowering
        self.total = total
        self._host = {}  # lazy host-side tables (never pytree leaves)


def _register_spmv_pytree():
    from jax.tree_util import register_pytree_node

    def flatten(p):
        children = (
            p.src_sorted,
            p.w_dst_order,
            p.indptr_src,
            p.indptr_dst,
            p.perm_plan,
            p.valid_dst_order,
            p.src_dst_order,
            p.place_plan,
            p.collect_plan,
            p.seg_start_src,
            p.seg_dst,
            p.dst_nonempty,
            p.loop_plan,
            p.start_has_state,
            p.is_last_dst,
            p.outdeg_start,
            p.last_dangling,
            p.fill_j,
            p.fill_hp,
        )
        return children, (p.n, p.e_pad, p.k_iso_dangling, p.loop_donors, p.total)

    def unflatten(aux, children):
        return SpmvPlan(
            aux[0], aux[1], *children,
            k_iso_dangling=aux[2], loop_donors=aux[3], total=aux[4],
        )

    register_pytree_node(SpmvPlan, flatten, unflatten)


_register_spmv_pytree()


def _exc_index_out_of_bounds(n, src, dst):
    from ..exceptions import IndexOutOfBound

    return IndexOutOfBound(
        f"edge endpoints out of range for n={n}: "
        f"src in [{int(src.min())}, {int(src.max())}], dst in [{int(dst.min())}, {int(dst.max())}]"
    )


def _complete_permutation(partial, e_pad):
    """Fill -1 targets of a partial routing with the unused sources."""
    used = np.zeros(e_pad, bool)
    assigned = partial >= 0
    used[partial[assigned]] = True
    partial[~assigned] = np.flatnonzero(~used)
    return partial


_BUILD_POOL = None


def _network_builder():
    """submit(fn, *a, **kw) -> job with .result(); parallel on multi-core
    hosts (GRAPHBLAS_TPU_PARALLEL_BUILD=0 forces serial).  One shared pool
    per process (the native router releases the GIL and is re-entrant)."""
    import os

    cores = os.cpu_count() or 1
    if cores <= 1 or os.environ.get("GRAPHBLAS_TPU_PARALLEL_BUILD", "1") != "1":
        class _Now:
            def __init__(self, value):
                self._value = value

            def result(self):
                return self._value

        return lambda fn, *a, **kw: _Now(fn(*a, **kw))
    global _BUILD_POOL
    if _BUILD_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _BUILD_POOL = ThreadPoolExecutor(
            max_workers=min(4, cores), thread_name_prefix="gbtpu-netbuild"
        )
    return _BUILD_POOL.submit


def build_spmv_plan(src, dst, w=None, *, n=None, pad_to=0, loop_net=True, total=False):
    """Analyze a COO graph into an SpmvPlan (host-side, once per graph).

    Besides the src->dst permutation, the plan carries the place/collect
    networks that move n-vectors into and out of the edge space.
    ``pad_to`` forces a minimum network size —
    used by the multi-chip build to give every device partition identical
    static shapes (parallel/fastspmv.py stacks the per-device plans).

    ``total=True`` gives EVERY vertex a dst segment by pointing one invalid
    pad edge at each in-degree-0 vertex: in the edge/loop layout every vertex
    then owns a state slot (its dst-seg-last slot), which makes the layout
    lossless for arbitrary per-vertex state — the requirement of the compiled
    DSL loop's edge-layout lowering (core/looplayout.py).  Semantics of every
    other path are unchanged (the extra pad edges are invalid, so they
    contribute nothing and ``dst_nonempty`` still reflects VALID in-edges).
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    e = len(src)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    elif e and (
        min(int(src.min()), int(dst.min())) < 0
        or max(int(src.max()), int(dst.max())) >= n
    ):
        # reference raises GrB_INDEX_OUT_OF_BOUNDS for edges past the
        # dimension (core/matrix.py from_coo validation)
        raise _exc_index_out_of_bounds(n, src, dst)
    # the place/collect endpoints embed n-vectors in the edge space
    e_pad = padded_size(max(e, n, pad_to))
    stateless = None
    if total:
        stateless = np.flatnonzero(np.bincount(dst, minlength=n) == 0)
        if e + len(stateless) > e_pad:
            e_pad = padded_size(max(e + len(stateless), n, pad_to))
    # pad with edges (n-1 -> n-1) marked invalid; they sort to the end-ish but
    # validity masks them out of the reduce
    pad = e_pad - e
    src_p = np.concatenate([src, np.full(pad, n - 1, np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, n - 1, np.int32)])
    if stateless is not None and len(stateless):
        # one invalid pad edge per in-degree-0 vertex -> a state slot each
        dst_p[e : e + len(stateless)] = stateless.astype(np.int32)
    valid_p = np.zeros(e_pad, bool)
    valid_p[:e] = True
    w_p = None
    if w is not None:
        w_arr = np.asarray(w)
        if w_arr.dtype not in (np.dtype(np.float32), np.dtype(np.int32)):
            w_arr = w_arr.astype(np.float32)
        w_p = np.concatenate([w_arr, np.zeros(pad, w_arr.dtype)])

    order_src = counting_sort(src_p, n)  # src-sorted edge ids
    order_dst = counting_sort(dst_p, n)  # dst-sorted edge ids
    # kept host-side on the plan so the disk cache can re-derive the weight
    # channel for SAME-PATTERN matrices with different values (the networks
    # are pure pattern analysis — SuiteSparse's symbolic/numeric split)
    order_dst_np = order_dst.astype(np.int32) if e_pad < (1 << 31) else order_dst
    # permutation: dst-order position p draws from src-order position q:
    # contrib_dst[p] = contrib_src[rank_src[order_dst[p]]]
    rank_src = np.empty(e_pad, np.int64)
    rank_src[order_src] = np.arange(e_pad)
    middle_perm = rank_src[order_dst]
    # the 2-4 network builds are independent; on multi-core hosts they run
    # in parallel threads (the native router releases the GIL, no shared
    # state — router.cpp is re-entrant).
    _nb = _network_builder()
    perm_job = _nb(build_permutation_plan, middle_perm, validate=False)

    src_sorted = src_p[order_src]
    counts_src = np.bincount(src_p, minlength=n)
    indptr_src = np.concatenate([[0], np.cumsum(counts_src)]).astype(np.int32)
    counts_dst = np.bincount(dst_p, minlength=n)
    indptr_dst = np.concatenate([[0], np.cumsum(counts_dst)]).astype(np.int32)

    loop_plan = None
    starts_src = indptr_src[:-1].astype(np.int64)
    ne_src = counts_src > 0
    # place: out[start slot of src i] = x[i]; filler elsewhere (fill-scan
    # only reads flagged slots, so filler values never surface)
    perm0 = np.full(e_pad, -1, np.int64)
    perm0[starts_src[ne_src]] = np.flatnonzero(ne_src)
    place_job = _nb(
        lambda p0: build_permutation_plan(_complete_permutation(p0, e_pad), validate=False),
        perm0,
    )
    ssrc = np.zeros(e_pad, bool)
    ssrc[starts_src[ne_src]] = True
    seg_start_src = ssrc
    # collect: out[d] = scanned[last slot of dst segment d]; empty dst
    # positions read filler slots and are masked by dst_nonempty
    ne_dst = counts_dst > 0
    perm2 = np.full(e_pad, -1, np.int64)
    perm2[np.flatnonzero(ne_dst)] = indptr_dst[1:].astype(np.int64)[ne_dst] - 1
    collect_job = _nb(
        lambda p2: build_permutation_plan(_complete_permutation(p2, e_pad), validate=False),
        perm2,
    )
    # dst segment id of every dst-order slot: the dst vertex (sorted)
    seg_dst = dst_p[order_dst]
    # valid-edge in-degree (pad edges at n-1 must not count)
    dst_nonempty = np.bincount(dst, minlength=n) > 0
    # -- loop layout (v3): route state (dst-seg-last slots) directly to
    # the next iteration's expand inputs (src-seg-start slots) in ONE
    # network — the composition of collect and place without the n-space
    # round trip between them
    last_dst = indptr_dst[1:].astype(np.int64) - 1
    has_state = counts_dst > 0  # incl. pad edges: slot existence only
    both = ne_src & has_state
    shs = np.zeros(e_pad, bool)
    shs[starts_src[both]] = True
    start_has_state = shs
    il = np.zeros(e_pad, bool)
    il[last_dst[has_state]] = True
    is_last_dst = il
    if loop_net:
        # only the model loop-layout algorithms use the loop network;
        # DSL dispatch plans skip it (saves ~1/4 of the analysis)
        perm3 = np.full(e_pad, -1, np.int64)
        perm3[starts_src[both]] = last_dst[both]
        # DONOR ROUTING: start slots whose vertex has NO state slot read
        # a non-last slot.  The state kernels keep non-last slots at the
        # mode identity (BFS frontier 0; SSSP STATE_BIG), so the routed
        # array IS x_start — the start_has_state select (a full e_pad
        # HBM pass per loop iteration) disappears.  Always feasible:
        # #non-last slots = e_pad - #state slots >= #no-state starts,
        # because #states + #no-state-starts <= #non-isolated <= n <= e_pad.
        nostate = ne_src & ~has_state
        k_ns = int(nostate.sum())
        if k_ns:
            donors = np.flatnonzero(~il)[:k_ns]
            assert len(donors) == k_ns, "donor pool exhausted (impossible by counting)"
            perm3[starts_src[nostate]] = donors
        loop_job = _nb(
            lambda p3: build_permutation_plan(_complete_permutation(p3, e_pad), validate=False),
            perm3,
        )
    true_outdeg = np.bincount(src, minlength=n)  # valid edges only
    od = np.ones(e_pad, np.float32)
    od[starts_src[ne_src]] = np.maximum(true_outdeg[ne_src], 1).astype(np.float32)
    outdeg_start = od
    dangling = true_outdeg == 0
    ld = np.zeros(e_pad, bool)
    ld[last_dst[has_state & dangling]] = True
    last_dangling = ld
    k_iso_dangling = int(np.sum(dangling & ~has_state))

    from .segscan import build_fill_tables

    fill_j, fill_hp = build_fill_tables(seg_start_src)

    perm_plan = perm_job.result()
    place_plan = place_job.result()
    collect_plan = collect_job.result()
    if loop_net:
        loop_plan = loop_job.result()

    plan = SpmvPlan(
        n,
        e_pad,
        jnp.asarray(src_sorted),
        jnp.asarray(w_p[order_dst]) if w_p is not None else None,
        jnp.asarray(indptr_src),
        jnp.asarray(indptr_dst),
        perm_plan,
        jnp.asarray(valid_p[order_dst]),
        jnp.asarray(src_p[order_dst].astype(np.int32)),
        place_plan,
        collect_plan,
        jnp.asarray(seg_start_src),
        jnp.asarray(seg_dst),
        jnp.asarray(dst_nonempty),
        loop_plan,
        jnp.asarray(start_has_state),
        jnp.asarray(is_last_dst),
        jnp.asarray(outdeg_start),
        jnp.asarray(last_dangling),
        jnp.asarray(fill_j),
        jnp.asarray(fill_hp),
        k_iso_dangling=k_iso_dangling,
        loop_donors=bool(loop_net),
        total=bool(total),
    )
    plan._order_dst = order_dst_np  # host-only (not a pytree leaf)
    return plan


def host_tables(plan):
    """Lazy host-side lookup tables for the edge/loop layout (trace-time
    conversions in core/looplayout.py; derived once per plan, cached).

    - ``v_of_slot`` int64 (e_pad,): the dst vertex owning each dst-order slot
    - ``is_last`` bool (e_pad,): dst-seg-last slots (the state slots)
    - ``slot_of_v`` int64 (n,): each vertex's state slot (total plans only)
    - ``dst_nonempty`` bool (n,)
    """
    h = plan._host
    if not h:
        ipd = np.asarray(plan.indptr_dst).astype(np.int64)
        h["v_of_slot"] = np.repeat(np.arange(plan.n, dtype=np.int64), np.diff(ipd))
        h["is_last"] = np.asarray(plan.is_last_dst)
        h["slot_of_v"] = ipd[1:] - 1
        h["dst_nonempty"] = np.asarray(plan.dst_nonempty)
    return h


def _expand_v2(x, plan):
    """x (n,) -> x[src] in src-sorted order with NO scatter: embed x in the
    edge space, route it to segment starts with the static place network,
    then segmented forward-fill."""
    pad = plan.e_pad - x.shape[0]
    x_emb = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)]) if pad else x
    placed = apply_plan(x_emb, plan.place_plan)
    return _seg_fill(plan, placed)


def _seg_fill(plan, placed):
    """Segmented forward-fill across src segments: one static gather from
    each slot's segment start."""
    from .segscan import segmented_fill_static

    return segmented_fill_static(placed, plan.fill_j, plan.fill_hp)


def _reduce_dst(plan, xe_dst, w, valid, op, mul, wrap=None):
    """Segmented reduce of dst-order contributions: every slot gets its dst
    segment's total (ops/segscan)."""
    from .segscan import segmented_reduce_contrib

    return segmented_reduce_contrib(xe_dst, w, valid, plan.seg_dst, op, mul, plan.n, wrap=wrap)


def _count_dst(plan, valid, dtype):
    from .segscan import segmented_reduce

    return segmented_reduce(valid.astype(dtype), plan.seg_dst, "add", plan.n)


def _collect_v2(scanned, plan, ident):
    """Segment totals -> y (n,) with NO gather: the static collect network
    brings each dst segment's last slot (its total) to position d; empty
    destinations are masked to the identity."""
    collected = apply_plan(scanned, plan.collect_plan)
    return jnp.where(plan.dst_nonempty, collected[: plan.n], ident)


def _ident_of(dtype, kind):
    if kind == "plus":
        return np.zeros((), dtype)[()]
    if np.issubdtype(np.dtype(dtype), np.floating):
        return np.asarray(np.inf if kind == "min" else -np.inf, dtype)[()]
    info = np.iinfo(np.dtype(dtype))
    return np.asarray(info.max if kind == "min" else info.min, dtype)[()]


def _pack_network(arrays, plan, prefix):
    kinds = []
    for i, s in enumerate(plan.stages):
        if s[0] == "S":
            kinds.append("S")
            arrays[f"{prefix}stage{i}"] = np.asarray(s[1])
        elif s[0] == "T":
            kinds.append(f"T{s[1]}")
        else:
            # "R<m>" = rotated lane-shuffle ROWSEL; "Q<m>" = m-way select
            kinds.append(("R" if s[0] == "ROWSEL" else "Q") + str(s[2]))
            arrays[f"{prefix}stage{i}"] = np.asarray(s[1])
    arrays[f"{prefix}kinds"] = np.asarray(kinds)


def _unpack_network(data, prefix, e_pad):
    import jax.numpy as jnp

    if f"{prefix}kinds" not in data:
        return None
    stages = []
    for i, kind in enumerate(data[f"{prefix}kinds"]):
        kind = str(kind)
        if kind == "S":
            stages.append(("S", jnp.asarray(data[f"{prefix}stage{i}"])))
        elif kind.startswith("T"):
            stages.append(("T", int(kind[1:])))
        elif kind.startswith("Q"):
            stages.append(("RSEL", jnp.asarray(data[f"{prefix}stage{i}"]), int(kind[1:])))
        else:
            # "R<m>": 3-dim = (m, s2, 128) src_top select table;
            # 2-dim = lane-shuffle table — invert it back to the select
            # form, the default.  The shuffle form only runs under
            # GRAPHBLAS_TPU_ROWSEL_SHUFFLE=1.
            from .permute import _rowsel_shuffle_enabled, _rowsel_table, _rowsel_unshuffle

            m = int(kind[1:])
            arr = data[f"{prefix}stage{i}"]
            if _rowsel_shuffle_enabled() and 128 % m == 0:
                if arr.ndim == 3:
                    arr = _rowsel_table(arr, m)
                stages.append(("ROWSEL", jnp.asarray(arr), m))
            else:
                if arr.ndim == 2:
                    arr = _rowsel_unshuffle(arr, m)
                stages.append(("RSEL", jnp.asarray(arr), m))
    return PermutePlan(e_pad, stages)


def save_spmv_plan(plan, path):
    """Serialize an SpmvPlan (host-side plan cache; the pattern-analysis
    result is reusable across processes)."""
    arrays = {
        "src_sorted": np.asarray(plan.src_sorted),
        "indptr_src": np.asarray(plan.indptr_src),
        "indptr_dst": np.asarray(plan.indptr_dst),
        "valid_dst_order": np.asarray(plan.valid_dst_order),
        "meta": np.asarray([plan.n, plan.e_pad], np.int64),
    }
    if plan.w_dst_order is not None:
        arrays["w_dst_order"] = np.asarray(plan.w_dst_order)
    if plan.src_dst_order is not None:
        arrays["src_dst_order"] = np.asarray(plan.src_dst_order)
    _pack_network(arrays, plan.perm_plan, "")
    _pack_network(arrays, plan.place_plan, "p0_")
    _pack_network(arrays, plan.collect_plan, "p2_")
    arrays["seg_start_src"] = np.asarray(plan.seg_start_src)
    arrays["dst_nonempty"] = np.asarray(plan.dst_nonempty)
    if plan.loop_plan is not None:
        _pack_network(arrays, plan.loop_plan, "p3_")
        arrays["start_has_state"] = np.asarray(plan.start_has_state)
        arrays["is_last_dst"] = np.asarray(plan.is_last_dst)
        arrays["outdeg_start"] = np.asarray(plan.outdeg_start)
        arrays["last_dangling"] = np.asarray(plan.last_dangling)
        arrays["k_iso_dangling"] = np.asarray([plan.k_iso_dangling], np.int64)
        # r5+: loop network routes no-state starts from identity donor slots
        arrays["loop_donors"] = np.asarray([int(plan.loop_donors)], np.int64)
    arrays["total"] = np.asarray([int(plan.total)], np.int64)
    if getattr(plan, "_order_dst", None) is not None:
        # lets the disk cache serve same-pattern matrices with different
        # values (load_spmv_plan(w=...) re-derives the weight channel)
        arrays["order_dst"] = plan._order_dst
    np.savez(path, **arrays)


def load_spmv_plan(path, w=None):
    """Load a cached plan.  ``w`` (optional, length e) replaces the stored
    weight channel: the networks are pure PATTERN analysis, so one cached
    plan serves every same-pattern matrix (symbolic/numeric split)."""
    import jax.numpy as jnp

    data = np.load(path, allow_pickle=False)
    n, e_pad = (int(v) for v in data["meta"])
    w_dst = None
    if w is not None:
        if "order_dst" not in data:
            raise ValueError("plan file predates weight-override support")
        w_arr = np.asarray(w)
        if w_arr.dtype not in (np.dtype(np.float32), np.dtype(np.int32)):
            w_arr = w_arr.astype(np.float32)
        w_p = np.concatenate([w_arr, np.zeros(e_pad - len(w_arr), w_arr.dtype)])
        w_dst = jnp.asarray(w_p[data["order_dst"]])
    elif "w_dst_order" in data:
        w_dst = jnp.asarray(data["w_dst_order"])
    perm_plan = _unpack_network(data, "", e_pad)
    # derived host-side at load (cheap); not part of the disk format
    from .segscan import build_fill_tables

    fill_j, fill_hp = build_fill_tables(data["seg_start_src"])
    indptr_dst = np.asarray(data["indptr_dst"]).astype(np.int64)
    seg_dst = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr_dst))
    return SpmvPlan(
        n,
        e_pad,
        jnp.asarray(data["src_sorted"]),
        w_dst,
        jnp.asarray(data["indptr_src"]),
        jnp.asarray(data["indptr_dst"]),
        perm_plan,
        jnp.asarray(data["valid_dst_order"]),
        jnp.asarray(data["src_dst_order"].astype(np.int32)) if "src_dst_order" in data else None,
        _unpack_network(data, "p0_", e_pad),
        _unpack_network(data, "p2_", e_pad),
        jnp.asarray(data["seg_start_src"]),
        jnp.asarray(seg_dst),
        jnp.asarray(data["dst_nonempty"]),
        _unpack_network(data, "p3_", e_pad),
        jnp.asarray(data["start_has_state"]) if "start_has_state" in data else None,
        jnp.asarray(data["is_last_dst"]) if "is_last_dst" in data else None,
        jnp.asarray(data["outdeg_start"]) if "outdeg_start" in data else None,
        jnp.asarray(data["last_dangling"]) if "last_dangling" in data else None,
        jnp.asarray(fill_j),
        jnp.asarray(fill_hp),
        k_iso_dangling=int(data["k_iso_dangling"][0]) if "k_iso_dangling" in data else 0,
        # plans cached before r5 lack donor routing: keep the select path
        loop_donors=bool(int(data["loop_donors"][0])) if "loop_donors" in data else False,
        total=bool(int(data["total"][0])) if "total" in data else False,
    )


def _no_x64(fn):
    """Trace with x64 off: the plan engine is a strictly 32-bit domain
    (f32/int32 channels), regardless of the global jax_enable_x64 setting."""
    import functools as _ft

    @_ft.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.enable_x64(False):
            return fn(*args, **kwargs)

    return wrapper


def _engine_jit(*static):
    """jax.jit that inlines when already inside an outer (gb.compile) trace,
    so concrete structure inputs stay concrete through the engine."""

    def deco(fn):
        jfn = jax.jit(fn, static_argnames=static)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from jax._src import core as _jcore

            if not _jcore.trace_state_clean():
                return fn(*args, **kwargs)
            return jfn(*args, **kwargs)

        return wrapper

    return deco


@_engine_jit("add", "mul", "x_full", "wrap")
@_no_x64
def spmv_masked(plan: SpmvPlan, x, xs, add="plus", mul="times", x_full=False, wrap=None):
    """DSL-exact SpMV: like ``spmv`` but honors x's structure and returns
    (values, struct).

    y[d] = ADD over edges (s->d) with x[s] PRESENT of contrib; y has an entry
    at d iff at least one such edge exists (GraphBLAS semantics — reference
    GrB_mxv, core/matrix.py:2203).  The x-structure rides the same
    expand/permute network as the values (an extra f32 channel) unless
    ``x_full`` says it is statically all-present.  ``mul`` additionally
    supports "secondi" (positional: contribution = src vertex id, a static
    per-plan channel — the any_secondi parent-BFS semiring).
    """
    op = {"plus": "add", "min": "min", "max": "max", "any": "max"}[add]

    def expand(v):
        return apply_plan(_expand_v2(v, plan), plan.perm_plan)

    if x_full:
        validc = plan.valid_dst_order
    else:
        validc = plan.valid_dst_order & (expand(xs.astype(jnp.float32)) > 0.5)

    if mul == "pair":
        # pair/oneb: every valid contribution is exactly 1, so ONE segmented
        # count over the validity channel answers both the values and the
        # structure — no value-channel expand (two networks), no second
        # reduce, no second collect.  plus -> the count; min/max/any -> 1.
        cnt = _count_dst(plan, validc, x.dtype)
        ycnt = _collect_v2(cnt, plan, jnp.zeros((), cnt.dtype))
        ys = plan.dst_nonempty & (ycnt > 0) if not x_full else plan.dst_nonempty
        one = jnp.ones((), ycnt.dtype)
        yv = ycnt if add == "plus" else jnp.where(ycnt > 0, one, jnp.zeros((), ycnt.dtype))
        if wrap is not None and add == "plus":
            bits, signed = wrap
            lo = -(1 << (bits - 1)) if signed else 0
            span = 1 << bits
            yv = ((yv - lo) % span + lo).astype(yv.dtype)
        return jnp.where(ys, yv, jnp.zeros((), yv.dtype)), ys

    if mul == "secondi":
        xe_dst = plan.src_dst_order
        w = None
        chan_mul = "first"
    else:
        xe_dst = expand(x)
        w = plan.w_dst_order if mul in ("times", "plus", "second") else None
        if w is not None and w.dtype != xe_dst.dtype:
            # channel mismatch (e.g. bool matrix weights with an f32 x):
            # align dtypes ahead of the fused reduce
            w = w.astype(xe_dst.dtype)
        chan_mul = mul
    scanned = _reduce_dst(plan, xe_dst, w, validc, op, chan_mul, wrap=wrap)
    ident = _ident_of(scanned.dtype, "max" if add == "any" else add)
    if x_full:
        ys = plan.dst_nonempty
    else:
        cnt = _count_dst(plan, validc, jnp.float32)
        ys = plan.dst_nonempty & (_collect_v2(cnt, plan, jnp.float32(0)) > 0)
    yv = _collect_v2(scanned, plan, ident)
    return jnp.where(ys, yv, jnp.zeros((), yv.dtype)), ys


@_engine_jit("add", "mul")
@_no_x64
def spmv(plan: SpmvPlan, x, add="plus", mul="times"):
    """y[d] = ADD over edges (s->d) of (x[s] MUL w).  add in {plus,min,max};
    mul in {times,plus,first,second}.  Absent/invalid edges contribute the
    ADD identity.  The per-edge multiply + validity mask fuse into the
    segmented reduce."""
    xe_dst = apply_plan(_expand_v2(x, plan), plan.perm_plan)
    w = plan.w_dst_order if mul in ("times", "plus", "second") else None
    op = {"plus": "add", "min": "min", "max": "max"}[add]
    scanned = _reduce_dst(plan, xe_dst, w, plan.valid_dst_order, op, mul)
    return _collect_v2(scanned, plan, _ident_of(scanned.dtype, add))


# ---------------------------------------------------------------------------
# Loop-layout SpMV (v3): iterative algorithms keep state in the edge space
# ---------------------------------------------------------------------------
#
# In PageRank/BFS/SSSP the output y of one SpMV is (after an elementwise
# update) the input x of the next.  ``spmv`` pays three 11-stage networks per
# pass (place, perm, collect); but collect∘elementwise∘place is itself a
# static permutation composed with a pointwise map, so the loop body needs
# only TWO networks:
#
#     state (totals at dst-seg-LAST slots)
#       --loop_plan-->  x at src-seg-START slots   [1 network]
#       --fill------->  x[src] per edge, src order
#       --perm_plan-->  dst order                  [1 network]
#       --reduce----->  new state (totals at dst-seg-last slots)
#
# The elementwise update runs in the e_pad layout (masked to the meaningful
# slots); one final `collect` back to n-space is paid once per ALGORITHM,
# not once per iteration.


def spmv_state(plan: SpmvPlan, x_start, add, mul, w=None):
    """One loop-layout SpMV step: values at src-seg-start slots -> the dst
    segment totals, whose dst-seg-LAST slots hold y[d].

    ``x_start`` must carry the source values exactly at ``seg_start_src``
    slots (other slots are ignored by the fill).  Returns the e_pad array
    (state layout); read it at ``is_last_dst`` slots.
    """
    xe = _seg_fill(plan, x_start)
    xe_dst = apply_plan(xe, plan.perm_plan)
    if w is None:
        w = plan.w_dst_order if mul in ("times", "plus", "second") else None
    op = {"plus": "add", "min": "min", "max": "max", "any": "max"}[add]
    return _reduce_dst(plan, xe_dst, w, plan.valid_dst_order, op, mul)


def state_to_start(plan: SpmvPlan, v_state, fill_value):
    """Route state-layout values (at dst-seg-last slots) to src-seg-start
    slots through the composed loop network.  Start slots whose vertex has no
    state slot (zero in-edges incl. padding) read ``fill_value``."""
    routed = apply_plan(v_state, plan.loop_plan)
    return jnp.where(plan.start_has_state, routed, fill_value)


def state_to_start_post(plan: SpmvPlan, v_state, postlude, aux=(), scalars=()):
    """``state_to_start`` with the masking select (and any further pointwise
    prep — degree divide, source inject) applied as the loop network's
    epilogue: ``postlude(routed, aux, scalars)`` must itself apply the
    ``start_has_state`` select.  XLA fuses it into the final shuffle."""
    routed = apply_plan(v_state, plan.loop_plan)
    return postlude(
        routed,
        tuple(jnp.asarray(a) for a in aux),
        tuple(jnp.asarray(s).reshape(()) for s in scalars),
    )


def state_to_n(plan: SpmvPlan, v_state, ident):
    """Final read-out: state layout -> (n,) via the collect network.
    Vertices with no VALID in-edge get ``ident``."""
    return _collect_v2(v_state, plan, ident)
