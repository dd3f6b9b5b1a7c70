"""Graph algorithms on the permutation-network SpMV engine.

Same recipes as the sibling modules (bfs/sssp/pagerank — the reference's
notebook workloads), but the per-iteration mxv is ops/fastspmv.spmv (the
permutation-network engine) instead of the segment form.  Each algorithm is
still ONE lax.while_loop XLA program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fastspmv import (
    SpmvPlan,
    build_spmv_plan,
    spmv,
    spmv_masked,
    spmv_state,
    state_to_n,
    state_to_start,
    state_to_start_post,
)

_BIG = jnp.float32(3.4e38) / 4


def _spmv_state_update(plan, x_start, mode, state, depth):
    """Loop-layout SpMV step with the BFS/SSSP state update fused into the
    reduce: fill -> permute -> one segmented_reduce_state pass."""
    from ..ops.fastspmv import _seg_fill
    from ..ops.permute import apply_plan
    from ..ops.segscan import segmented_reduce_state

    xe = _seg_fill(plan, x_start)
    xe_dst = apply_plan(xe, plan.perm_plan)
    w = plan.w_dst_order if mode == "sssp" else None
    return segmented_reduce_state(
        mode, xe_dst, w, plan.valid_dst_order, plan.seg_dst, plan.n,
        plan.is_last_dst, state, depth,
    )


def _seed_round():
    """Relax the source's own out-edges at initialization (BFS/SSSP).

    Bellman-Ford/BFS round 1 only propagates from the source, but a network
    round costs full O(E) regardless of frontier size.  The seed computes
    round 1's entire effect as ONE fused segmented-scan pass (no networks):
    the source's out-edges are identified in dst order by the static
    ``src_dst_order`` channel, so the contribution array is a single
    elementwise select.  Exactly one full round is deleted (measured on the
    bench RMAT graphs: SSSP 7 -> 6 passes, BFS 6 -> 5, same fixpoint) —
    the standard "initialize distances from the source adjacency" opening
    move, done device-side so ``source`` stays a traced argument.
    GRAPHBLAS_TPU_SEED_ROUND=0 disables (A/B)."""
    import os

    return os.environ.get("GRAPHBLAS_TPU_SEED_ROUND", "1") == "1"


def _seed_ok(plan):
    """Seeding needs the static src-id channel and the state-slot tables."""
    return (
        _seed_round()
        and plan.src_dst_order is not None
        and plan.seg_dst is not None
        and plan.is_last_dst is not None
    )


def _seed_state(plan, mode, source, state0):
    """One-pass device seed: state after round 1, from all-unreached state0.

    mode="sssp": contributions are w(source->d); mode="bfs": frontier bit 1.
    Returns (state, frontier/changed) like segmented_reduce_state."""
    from ..ops.segscan import segmented_reduce_state

    src_eq = plan.src_dst_order == source
    if mode == "sssp":
        x_seed = jnp.where(src_eq, jnp.float32(0), _BIG)
    else:
        x_seed = src_eq.astype(jnp.float32)
    w = plan.w_dst_order if mode == "sssp" else None
    return segmented_reduce_state(
        mode, x_seed, w, plan.valid_dst_order, plan.seg_dst, plan.n,
        plan.is_last_dst, state0, 0,
    )


def _xstart_fuse(default):
    """Apply the x_start selects as the loop network's epilogue
    (``state_to_start_post``) instead of separate passes.  The per-algorithm
    defaults (PageRank fused, BFS/SSSP not) have not been re-measured on the
    GPU; GRAPHBLAS_TPU_XSTART_FUSE=0/1 overrides globally for experiments."""
    import os

    v = os.environ.get("GRAPHBLAS_TPU_XSTART_FUSE")
    if v in ("0", "1"):
        return v == "1"
    return default


def _xstart_mode(plan, donor_default):
    """x_start strategy for the BFS/SSSP loop bodies.

    - "select": route state through the loop network, then an XLA pass does
      the start_has_state select + source inject (the r2-r4 path).
    - "fused":  select + inject as a packed-aux epilogue of the loop
      network (kept for A/B).
    - "donor":  donor-routed plans only (plan.loop_donors): the routed array
      IS x_start (no select — non-last state slots hold the mode identity and
      no-state starts read them); the source inject stays an XLA pass.
    - "donor_post": donor routing + the inject as a minimal iota-compare
      epilogue of the loop network.
    GRAPHBLAS_TPU_XSTART_MODE overrides globally for experiments."""
    import os

    v = os.environ.get("GRAPHBLAS_TPU_XSTART_MODE")
    if v in ("select", "fused", "donor", "donor_where", "donor_state", "donor_post"):
        if v.startswith("donor") and not plan.loop_donors:
            return "select"
        return v
    if plan.loop_donors:
        return donor_default
    return "select"


def _inject_post(value):
    """Postlude for ``state_to_start_post``: overwrite ONE global slot (the
    source vertex's start slot, -1 = none) with ``value``."""

    def post(y, aux, s):
        (se,) = s
        return jnp.where(jax.lax.iota(jnp.int32, y.shape[0]) == se, value, y)

    return post


def _no_x64(fn):
    import functools as _ft

    @_ft.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.enable_x64(False):
            return fn(*args, **kwargs)

    return wrapper


def analyze(graph):
    """Build the SpmvPlan for a models.Graph (host-side, once).

    The build is host work: seconds to minutes per graph.
    """
    valid = np.asarray(graph.valid)
    src = np.asarray(graph.src)[valid]
    dst = np.asarray(graph.dst)[valid]
    w = np.asarray(graph.weights)[valid] if graph.weights is not None else None
    return build_spmv_plan(src, dst, w, n=graph.n)


@functools.partial(jax.jit, static_argnames=("n",))
@_no_x64
def _bfs_loop(plan, source, n):
    source = jnp.asarray(source, jnp.int32)
    levels0 = jnp.full((n,), -1, jnp.int32).at[source].set(0)
    frontier0 = jnp.zeros((n,), jnp.float32).at[source].set(1.0)

    def cond(state):
        _, frontier, depth = state
        return (frontier.max() > 0) & (depth < n)

    def body(state):
        levels, frontier, depth = state
        reached = spmv(plan, frontier, "max", "first") > 0
        nxt = reached & (levels < 0)
        levels = jnp.where(nxt, depth + 1, levels)
        return levels, nxt.astype(jnp.float32), depth + 1

    levels, _, _ = jax.lax.while_loop(cond, body, (levels0, frontier0, jnp.int32(0)))
    return levels


@functools.partial(jax.jit, static_argnames=("n", "mode", "seed"))
@_no_x64
def _bfs_loop_v3(plan, source, n, mode="select", seed=True):
    """Loop-layout BFS: levels state lives at dst-seg-last slots; each level
    is loop-network -> fill -> perm -> contrib-reduce (two 11-stage networks
    instead of three).  The frontier rides f32.
    ``mode`` picks the x_start strategy (see _xstart_mode)."""
    fdt = jnp.float32
    source = jnp.asarray(source, jnp.int32)
    is_last = plan.is_last_dst
    e_pad = plan.e_pad
    levels0 = jnp.full((e_pad,), -1, jnp.int32)
    # inject the source into the expand inputs every level: constant work,
    # already-discovered neighbors are filtered by levels < 0
    s_lo = plan.indptr_src[source]
    s_hi = plan.indptr_src[source + 1]
    s_eff = jnp.where(s_hi > s_lo, s_lo, jnp.int32(-1))
    slot = jax.lax.iota(jnp.int32, e_pad)
    src_inject = ((slot == s_lo) & (s_hi > s_lo)).astype(fdt)
    frontier0 = jnp.zeros((e_pad,), fdt)
    depth0 = 0
    if seed:
        # round 1 (relax the source's out-edges) as ONE scan pass at init:
        # deletes a full network round — see _seed_round
        levels0, frontier0 = _seed_state(plan, "bfs", source, levels0)
        depth0 = 1
    # donor_state: seed the source frontier IN the state array (round 1
    # routes it to the start slots; later frontiers never re-inject)
    t_lo = plan.indptr_dst[source]
    t_hi = plan.indptr_dst[source + 1]
    has_state = t_hi > t_lo
    if mode == "donor_state":
        sslot = jnp.where(has_state, t_hi - 1, 0)
        # .max: never clobber a level-1 frontier bit seeded at slot 0
        frontier0 = frontier0.at[sslot].max(jnp.where(has_state, fdt(1.0), fdt(0.0)))

    def cond(state):
        _, _, depth, active = state
        return active & (depth < n)

    # ONE packed aux stream (bit0 = start_has_state, bit1 = source inject)
    packed = plan.start_has_state.astype(fdt) + 2.0 * src_inject

    def post(y, aux, _s):
        (p,) = aux
        shs = (p == 1.0) | (p == 3.0)
        return jnp.maximum(jnp.where(shs, y, np.float32(0)), (p >= 2.0).astype(y.dtype))

    def body(state):
        levels, frontier, depth, _ = state
        if mode == "fused":
            # select + source-inject as the loop network's epilogue
            x_start = state_to_start_post(plan, frontier, post, aux=(packed,))
        elif mode in ("donor", "donor_where"):
            # donor-routed plan: routed IS x_start (frontier identity 0 at
            # non-last slots); only the source inject remains, one XLA pass.
            from ..ops.permute import apply_plan

            x_start = jnp.maximum(apply_plan(frontier, plan.loop_plan), src_inject)
        elif mode == "donor_state":
            # source seeded ONCE into the frontier state (its dst-seg-last
            # slot); the body is pure routing.  No-state sources (no
            # in-edges) fall back to the per-round inject via lax.cond.
            from ..ops.permute import apply_plan

            routed = apply_plan(frontier, plan.loop_plan)
            x_start = jax.lax.cond(
                has_state,
                lambda r: r,
                lambda r: jnp.maximum(r, src_inject),
                routed,
            )
        elif mode == "donor_post":
            # donor routing + inject as a minimal epilogue
            x_start = state_to_start_post(
                plan, frontier, _inject_post(np.float32(1.0)), scalars=(s_eff,)
            )
        else:
            x_start = state_to_start(plan, frontier, jnp.zeros((), fdt))
            x_start = jnp.maximum(x_start, src_inject)
        levels, frontier = _spmv_state_update(plan, x_start, "bfs", levels, depth)
        return levels, frontier, depth + 1, frontier.max() > 0

    levels, _, _, _ = jax.lax.while_loop(
        cond, body, (levels0, frontier0, jnp.int32(depth0), jnp.asarray(True))
    )
    out = state_to_n(plan, levels, jnp.int32(-1))
    return out.at[source].set(0)


def bfs_level(plan, source, n):
    if plan.loop_plan is not None:
        mode = _xstart_mode(plan, "donor")
        if mode == "fused" or (mode == "select" and _xstart_fuse(False)):
            mode = "fused"
        return _bfs_loop_v3(plan, int(source), n, mode=mode, seed=_seed_ok(plan))
    return _bfs_loop(plan, int(source), n)


@functools.partial(jax.jit, static_argnames=("n",))
@_no_x64
def _bfs_parent_loop(plan, source, n):
    """True any_secondi parent BFS (reference recipe: notebooks/Example B.3):
    the per-edge contribution is the static src-id channel of the plan; the
    frontier rides the validity channel, so each level is ONE masked SpMV."""
    source = jnp.asarray(source, jnp.int32)
    parents0 = jnp.full((n,), -1, jnp.int32).at[source].set(source)
    frontier0 = jnp.zeros((n,), bool).at[source].set(True)
    dummy_x = jnp.zeros((n,), jnp.float32)  # secondi ignores the value channel

    def cond(state):
        _, frontier, depth = state
        return frontier.any() & (depth < n)

    def body(state):
        parents, frontier, depth = state
        cand, reached = spmv_masked(plan, dummy_x, frontier, add="any", mul="secondi")
        nxt = reached & (parents < 0)
        parents = jnp.where(nxt, cand.astype(jnp.int32), parents)
        return parents, nxt, depth + 1

    parents, _, _ = jax.lax.while_loop(cond, body, (parents0, frontier0, jnp.int32(0)))
    return parents


def bfs_parent(plan, source, n):
    return _bfs_parent_loop(plan, int(source), n)


@functools.partial(jax.jit, static_argnames=("n",))
@_no_x64
def _sssp_loop(plan, source, n):
    source = jnp.asarray(source, jnp.int32)
    dist0 = jnp.full((n,), _BIG, jnp.float32).at[source].set(0.0)

    def cond(state):
        _, changed, it = state
        return changed & (it < n)

    def body(state):
        dist, _, it = state
        relaxed = spmv(plan, dist, "min", "plus")
        new_dist = jnp.minimum(dist, relaxed)
        return new_dist, (new_dist < dist).any(), it + 1

    dist, _, _ = jax.lax.while_loop(cond, body, (dist0, jnp.asarray(True), jnp.int32(0)))
    return dist


@functools.partial(jax.jit, static_argnames=("n", "mode", "seed"))
@_no_x64
def _sssp_loop_v3(plan, source, n, mode="select", seed=True):
    """Loop-layout Bellman-Ford: dist state at dst-seg-last slots; the source
    distance is injected into the expand inputs every round (covers sources
    with no in-edges without a dynamic state scatter).  Non-last state slots
    carry _BIG (the min identity, written by the state reduce) so donor-
    routed plans can skip the x_start select (``mode`` — see _xstart_mode)."""
    source = jnp.asarray(source, jnp.int32)
    is_last = plan.is_last_dst
    e_pad = plan.e_pad
    dist0 = jnp.full((e_pad,), _BIG, jnp.float32)
    s_lo = plan.indptr_src[source]
    s_hi = plan.indptr_src[source + 1]
    s_eff = jnp.where(s_hi > s_lo, s_lo, jnp.int32(-1))
    slot = jax.lax.iota(jnp.int32, e_pad)
    src_inject = (slot == s_lo) & (s_hi > s_lo)
    if seed:
        # round 1 (relax the source's out-edges) as ONE scan pass at init:
        # deletes a full network round — see _seed_round
        dist0, _ = _seed_state(plan, "sssp", source, dist0)
    # donor_state: the source's distance-0 lives IN the state array (its
    # dst-seg-last slot) from round 0 — the state reduce's min keeps it 0 forever
    t_lo = plan.indptr_dst[source]
    t_hi = plan.indptr_dst[source + 1]
    has_state = t_hi > t_lo
    if mode == "donor_state":
        sslot = jnp.where(has_state, t_hi - 1, 0)
        sval = jnp.where(has_state, jnp.float32(0), _BIG)
        # .min: never clobber a seeded 1-hop distance at slot 0
        dist0 = dist0.at[sslot].min(sval)

    def cond(state):
        _, changed, it = state
        return changed & (it < n)

    _BIG_NP = np.float32(3.4e38) / 4
    # ONE packed aux stream (bit0 = start_has_state, bit1 = source inject)
    packed = plan.start_has_state.astype(jnp.float32) + 2.0 * src_inject.astype(jnp.float32)

    def post(y, aux, _s):
        (p,) = aux
        shs = (p == 1.0) | (p == 3.0)
        return jnp.where(p >= 2.0, np.float32(0), jnp.where(shs, y, _BIG_NP))

    def body(state):
        dist, _, it = state
        if mode == "fused":
            # select + source-inject as the loop network's epilogue
            x_start = state_to_start_post(plan, dist, post, aux=(packed,))
        elif mode in ("donor", "donor_where"):
            # donor-routed plan: routed IS x_start (non-last slots hold _BIG);
            # only the source inject remains, one XLA pass.
            from ..ops.permute import apply_plan

            routed = apply_plan(dist, plan.loop_plan)
            x_start = jnp.where(src_inject, jnp.float32(0), routed)
        elif mode == "donor_state":
            # source injected ONCE into the state array (its dst-seg-last
            # slot) before the loop; the body is pure routing — zero inject
            # passes.  Sources with no in-edge have no state slot: lax.cond
            # falls back to the per-round inject only for those.
            from ..ops.permute import apply_plan

            routed = apply_plan(dist, plan.loop_plan)
            x_start = jax.lax.cond(
                has_state,
                lambda r: r,
                lambda r: jnp.where(src_inject, jnp.float32(0), r),
                routed,
            )
        elif mode == "donor_post":
            # donor routing + inject as a minimal epilogue
            x_start = state_to_start_post(
                plan, dist, _inject_post(np.float32(0.0)), scalars=(s_eff,)
            )
        else:
            x_start = state_to_start(plan, dist, _BIG)
            x_start = jnp.where(src_inject, jnp.float32(0), x_start)
        new, changed = _spmv_state_update(plan, x_start, "sssp", dist, it)
        return new, changed.max() > 0, it + 1

    dist, _, _ = jax.lax.while_loop(cond, body, (dist0, jnp.asarray(True), jnp.int32(0)))
    out = state_to_n(plan, dist, _BIG)
    return out.at[source].set(0.0)


def sssp(plan, source, n):
    """min_plus Bellman-Ford; the plan must carry edge weights."""
    if plan.loop_plan is not None and plan.w_dst_order is not None:
        mode = _xstart_mode(plan, "donor")
        if mode == "fused" or (mode == "select" and _xstart_fuse(False)):
            mode = "fused"
        return _sssp_loop_v3(plan, int(source), n, mode=mode, seed=_seed_ok(plan))
    return _sssp_loop(plan, int(source), n)


@functools.partial(jax.jit, static_argnames=("n", "max_iters", "tol"))
@_no_x64
def _pagerank_loop(plan, outdeg, n, damping, tol, max_iters):
    r0 = jnp.full((n,), 1.0 / n, jnp.float32)
    safe_deg = jnp.where(outdeg > 0, outdeg, 1).astype(jnp.float32)
    dangling = outdeg == 0

    def step(r):
        pulled = spmv(plan, r / safe_deg, "plus", "first")
        dangling_mass = jnp.sum(jnp.where(dangling, r, 0.0))
        return (1.0 - damping) / n + damping * (pulled + dangling_mass / n)

    if float(tol) <= 0.0:
        # fixed-iteration benchmark mode: fori_loop has no data-dependent
        # condition, so iterations pipeline without a per-step barrier
        r = jax.lax.fori_loop(0, max_iters, lambda i, r: step(r), r0)
        return r, jnp.int32(max_iters)

    def cond(state):
        _, delta, it = state
        return (delta > tol) & (it < max_iters)

    def body(state):
        r, _, it = state
        new_r = step(r)
        delta = jnp.sum(jnp.abs(new_r - r))
        return new_r, delta, it + 1

    r, _, iters = jax.lax.while_loop(cond, body, (r0, jnp.float32(jnp.inf), jnp.int32(0)))
    return r, iters


@functools.partial(jax.jit, static_argnames=("n", "max_iters", "tol", "fuse"))
@_no_x64
def _pagerank_loop_v3(plan, n, damping, tol, max_iters, fuse=True):
    """Loop-layout PageRank: rank state r at dst-seg-last slots; one scalar c
    carries the rank of state-less vertices ((1-d)/n + d*mass/n — identical
    for every vertex with no valid in-edge)."""
    d = damping
    is_last = plan.is_last_dst
    r0 = jnp.where(is_last, jnp.float32(1.0 / n), jnp.float32(0))
    c0 = jnp.float32(1.0 / n)

    # ONE packed aux stream: outdeg signed by start_has_state (outdeg >= 1
    # at start slots, so the sign carries the select bit for free)
    od_signed = jnp.where(plan.start_has_state, plan.outdeg_start, -plan.outdeg_start)

    def post(y, aux, s):
        (a,) = aux
        (c,) = s
        return jnp.where(a > 0, y / a, c / (-a))

    def step(r_state, c):
        mass = jnp.sum(jnp.where(plan.last_dangling, r_state, jnp.float32(0)))
        mass = mass + plan.k_iso_dangling * c
        if fuse:
            # select + stateless-rank fill + degree divide as the loop
            # network's epilogue
            x_start = state_to_start_post(plan, r_state, post, aux=(od_signed,), scalars=(c,))
        else:
            x_start = state_to_start(plan, r_state, c) / plan.outdeg_start
        pulled = spmv_state(plan, x_start, "plus", "first")
        c_new = (1.0 - d) / n + d * mass / n
        r_new = jnp.where(is_last, c_new + d * pulled, jnp.float32(0))
        return r_new, c_new

    if float(tol) <= 0.0:
        def body(i, state):
            return step(*state)

        r_state, c = jax.lax.fori_loop(0, max_iters, body, (r0, c0))
        it = jnp.int32(max_iters)
    else:
        def cond(state):
            _, _, delta, it = state
            return (delta > tol) & (it < max_iters)

        def body(state):
            r_state, c, _, it = state
            r_new, c_new = step(r_state, c)
            delta = jnp.sum(jnp.abs(r_new - r_state))
            return r_new, c_new, delta, it + 1

        r_state, c, _, it = jax.lax.while_loop(
            cond, body, (r0, c0, jnp.float32(jnp.inf), jnp.int32(0))
        )
    r = state_to_n(plan, r_state, jnp.float32(0))
    return jnp.where(plan.dst_nonempty, r, c), it


def pagerank(plan, outdeg, n, *, damping=0.85, tol=1e-6, max_iters=100):
    if plan.loop_plan is not None:
        r, _ = _pagerank_loop_v3(
            plan, n, jnp.float32(damping), float(tol), int(max_iters), fuse=_xstart_fuse(True)
        )
        return r
    r, _ = _pagerank_loop(plan, outdeg, n, jnp.float32(damping), float(tol), int(max_iters))
    return r
