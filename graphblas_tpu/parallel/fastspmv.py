"""Multi-chip permutation-network SpMV: the fast engine over a device mesh.

The reference has no distributed layer (SURVEY §2.2); this is new design.
The single-chip engine (ops/fastspmv) already factors a graph into static
per-graph routing networks; the multi-chip form is the natural SPMD
extension:

- **edge partition by destination range**: device k owns the edges whose
  dst falls in its n/P-slice, so the segmented reduce is entirely local to
  the device — no cross-chip traffic inside the pipeline;
- **one SpmvPlan per device**, all padded to one network size so every
  device runs the *same program* on different routing tables (classic SPMD:
  the tables are sharded data, the network program is the code);
- x replicates (frontier/rank vectors are n-sized — tiny next to the edge
  space); each device produces the full-length y with its own destinations
  filled and the monoid identity elsewhere, and ONE collective per SpMV
  (`psum` / `pmin` / `pmax` over the mesh axis) combines them,
  chosen by the add-monoid.

Plans stack leaf-wise (SpmvPlan and PermutePlan are pytrees), shard over a
1-D mesh axis, and the body simply calls the single-device ``spmv`` inside
``shard_map`` — multi-chip execution reuses the scalar engine verbatim.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..ops import fastspmv as _f


class ShardedSpmvPlan:
    """Per-device SpmvPlans stacked on a leading mesh axis."""

    def __init__(self, stacked, mesh, axis_name, ndev, n, bounds):
        self.stacked = stacked  # SpmvPlan pytree, every leaf (ndev, ...)
        self.mesh = mesh
        self.axis_name = axis_name
        self.ndev = ndev
        self.n = n
        self.bounds = bounds  # dst-range boundaries, len ndev+1
        self._fns = {}

    def __repr__(self):
        return f"ShardedSpmvPlan(n={self.n}, ndev={self.ndev}, axis={self.axis_name!r})"


def build_sharded_spmv_plan(src, dst, w=None, *, n=None, mesh=None, ndev=None, axis_name="d"):
    """Partition a COO graph by destination range and build the stacked plan.

    ``mesh`` may be an existing 1-D (or flattened) ``jax.sharding.Mesh``;
    otherwise one is created over all ``jax.devices()`` (or ``ndev`` of
    them).  Host-side, once per graph — the pattern-analysis step.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if mesh is None:
        devices = jax.devices()[: (ndev or len(jax.devices()))]
    else:
        # any mesh shape is accepted: the edge partition is 1-D, so flatten
        # the mesh's devices into a fresh 1-D mesh over the same hardware
        devices = list(mesh.devices.reshape(-1))
    mesh = Mesh(np.asarray(devices), (axis_name,))
    ndev = len(devices)

    bounds = [(k * n) // ndev for k in range(ndev + 1)]
    parts = []
    max_e = 0
    for k in range(ndev):
        m = (dst >= bounds[k]) & (dst < bounds[k + 1])
        parts.append(m)
        max_e = max(max_e, int(m.sum()))
    pad_to = _f.padded_size(max(max_e, n))

    plans = []
    for m in parts:
        p = _f.build_spmv_plan(
            src[m], dst[m], None if w is None else np.asarray(w)[m], n=n, pad_to=pad_to
        )
        # aux metadata must match across devices for leaf-wise stacking;
        # k_iso_dangling is only consumed by the single-chip pagerank loop
        p.k_iso_dangling = 0
        plans.append(p)

    kinds = {repr(p.perm_plan) for p in plans}
    if len(kinds) != 1:  # same pad_to => same network structure
        raise AssertionError(f"device plans disagree on network structure: {kinds}")

    stacked = jax.tree.map(lambda *leaves: jnp.stack(leaves), *plans)
    # commit every leaf to its device up front (sharded along the mesh axis)
    sharding = NamedSharding(mesh, P(axis_name))
    stacked = jax.tree.map(lambda a: jax.device_put(a, sharding), stacked)
    return ShardedSpmvPlan(stacked, mesh, axis_name, ndev, n, bounds)


def _combine(y, add, axis_name):
    if add == "plus":
        return jax.lax.psum(y, axis_name)
    if add == "min":
        return jax.lax.pmin(y, axis_name)
    return jax.lax.pmax(y, axis_name)  # max / any


def _get_fn(splan, add, mul, masked):
    key = (add, mul, masked)
    fn = splan._fns.get(key)
    if fn is not None:
        return fn
    axis = splan.axis_name

    if masked:

        def local(plan_block, x, xs):
            plan = jax.tree.map(lambda a: a[0], plan_block)
            yv, ys = _f.spmv_masked(plan, x, xs, add=add, mul=mul)
            ident = _f._ident_of(yv.dtype, "max" if add == "any" else add)
            yv = jnp.where(ys, yv, ident)
            yv = _combine(yv, add, axis)
            ys = jax.lax.pmax(ys.astype(jnp.int32), axis) > 0
            return jnp.where(ys, yv, jnp.zeros((), yv.dtype)), ys

        shmap = jax.shard_map(
            local,
            mesh=splan.mesh,
            in_specs=(P(axis), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
    else:

        def local(plan_block, x):
            plan = jax.tree.map(lambda a: a[0], plan_block)
            y = _f.spmv(plan, x, add=add, mul=mul)
            return _combine(y, add, axis)

        shmap = jax.shard_map(
            local, mesh=splan.mesh, in_specs=(P(axis), P()), out_specs=P(), check_vma=False
        )
    fn = jax.jit(shmap)
    splan._fns[key] = fn
    return fn


def sharded_spmv(splan, x, add="plus", mul="times"):
    """y[d] = ADD over edges (s->d) of (x[s] MUL w), over the mesh.

    One collective per call (psum/pmin/pmax along the mesh axis); everything
    else is device-local network passes.  y is replicated.
    """
    return _get_fn(splan, add, mul, False)(splan.stacked, jnp.asarray(x, jnp.float32))


def sharded_spmv_masked(splan, x, xs, add="plus", mul="times"):
    """DSL-exact masked SpMV over the mesh: honors x's structure, returns
    (values, struct).  ``mul='secondi'`` (parent BFS) works — the positional
    channel is per-device static data."""
    fn = _get_fn(splan, add, mul, True)
    return fn(splan.stacked, jnp.asarray(x, jnp.float32), jnp.asarray(xs, bool))


def sharded_bfs_level(splan, source):
    """Level BFS over the mesh: one sharded max/first SpMV per level, whole
    loop in ONE jitted program (single collective per level)."""
    n = splan.n
    spmv_fn = _get_fn(splan, "max", "first", False)
    source = int(source)

    @jax.jit
    def run(stacked):
        levels0 = jnp.full((n,), -1, jnp.int32).at[source].set(0)
        frontier0 = jnp.zeros((n,), jnp.float32).at[source].set(1.0)

        def cond(state):
            _, frontier, depth = state
            return (frontier.max() > 0) & (depth < n)

        def body(state):
            levels, frontier, depth = state
            reached = spmv_fn(stacked, frontier) > 0
            nxt = reached & (levels < 0)
            return jnp.where(nxt, depth + 1, levels), nxt.astype(jnp.float32), depth + 1

        levels, _, _ = jax.lax.while_loop(cond, body, (levels0, frontier0, jnp.int32(0)))
        return levels

    return run(splan.stacked)


def sharded_sssp(splan, source):
    """Bellman-Ford over the mesh (min/plus; the plan must carry weights)."""
    n = splan.n
    big = jnp.float32(3.4e38) / 4
    spmv_fn = _get_fn(splan, "min", "plus", False)
    source = int(source)

    @jax.jit
    def run(stacked):
        dist0 = jnp.full((n,), big, jnp.float32).at[source].set(0.0)

        def cond(state):
            _, changed, it = state
            return changed & (it < n)

        def body(state):
            dist, _, it = state
            relaxed = spmv_fn(stacked, dist)
            new = jnp.minimum(dist, relaxed)
            return new, (new < dist).any(), it + 1

        dist, _, _ = jax.lax.while_loop(cond, body, (dist0, jnp.asarray(True), jnp.int32(0)))
        return dist

    return run(splan.stacked)


def sharded_pagerank(splan, *, damping=0.85, tol=1e-6, max_iters=100, outdeg=None):
    """PageRank over the mesh: per-iteration one sharded plus_times SpMV +
    replicated elementwise update, the whole loop in ONE jitted program.

    ``outdeg`` (n,) true out-degrees; derived from the stacked plans when
    omitted (psum of per-device local out-degree counts).
    """
    n = splan.n
    if outdeg is None:
        # per-device local outdegree from indptr_src diffs, psum'd once
        axis = splan.axis_name

        def local_od(plan_block):
            plan = jax.tree.map(lambda a: a[0], plan_block)
            # count VALID local out-edges per src: segment the valid flags
            deg = jax.ops.segment_sum(
                plan.valid_dst_order.astype(jnp.float32),
                plan.src_dst_order.astype(jnp.int32),
                num_segments=n,
            )
            return jax.lax.psum(deg, axis)

        outdeg = jax.jit(
            jax.shard_map(
                local_od, mesh=splan.mesh, in_specs=(P(axis),), out_specs=P(), check_vma=False
            )
        )(splan.stacked)
    outdeg = jnp.maximum(jnp.asarray(outdeg, jnp.float32), 0.0)
    dangling = outdeg == 0
    safe_deg = jnp.where(dangling, 1.0, outdeg)
    spmv_fn = _get_fn(splan, "plus", "first", False)

    @jax.jit
    def run(stacked):
        r0 = jnp.full((n,), 1.0 / n, jnp.float32)

        def body(state):
            r, _err, i = state
            contrib = r / safe_deg
            pulled = spmv_fn(stacked, contrib)
            dangle = jnp.sum(jnp.where(dangling, r, 0.0))
            r_new = (1.0 - damping) / n + damping * (pulled + dangle / n)
            return r_new, jnp.max(jnp.abs(r_new - r)), i + 1

        def cond(state):
            _r, err, i = state
            return (err > tol) & (i < max_iters)

        r, _e, iters = jax.lax.while_loop(cond, body, (r0, jnp.float32(jnp.inf), jnp.int32(0)))
        return r, iters

    return run(splan.stacked)
