"""Static permutation engine: arbitrary E-element permutations as a network
of regular data movements.

The network uses two regular movements: per-row 128-lane shuffles (a gather
within each 128-wide row) and tile transposes.  This module realizes ANY
static permutation as a Clos/Benes-style network of those primitives:

    [S T]*L  S ROWSEL S  [T S]*L

where S = per-row lane shuffle (routing tables from a 128-edge-coloring of a
bipartite multigraph — computed by the native router,
graphblas_tpu/native/router.cpp), T = digit-swap transpose, and ROWSEL = a
small m-way row exchange.  For N = m * 128^(L+1) elements the network has
2L+3 shuffle stages and 2L transposes.

The plan is built once per (graph, layout) on the host and reused every
iteration — the analogue of SuiteSparse analyzing a sparse pattern once and
reusing the factorization.
"""

import numpy as np

from ..native import euler_color, euler_color_batched


class PermutePlan:
    """A compiled route: apply with ``apply_plan``.  Stages:
    ("S", idx[R,128] int32) | ("T", level) | ("ROWSEL", src_top[m,128^L,128] int32, m)

    Registered as a JAX pytree so routing tables travel as device arguments
    (not embedded HLO constants) when a plan is closed over under ``jit``.
    """

    def __init__(self, n, stages):
        self.n = n
        self.stages = stages

    def __repr__(self):
        kinds = "".join(s[0][0] for s in self.stages)
        return f"PermutePlan(n={self.n}, stages={kinds})"

    def tree_flatten(self):
        children = []
        aux = [self.n]
        for s in self.stages:
            if s[0] == "S":
                children.append(s[1])
                aux.append(("S",))
            elif s[0] == "T":
                aux.append(("T", s[1]))
            else:
                children.append(s[1])
                aux.append((s[0], s[2]))
        return children, tuple(aux)

    @classmethod
    def tree_unflatten(cls, aux, children):
        n = aux[0]
        stages = []
        it = iter(children)
        for item in aux[1:]:
            if item[0] == "S":
                stages.append(("S", next(it)))
            elif item[0] == "T":
                stages.append(("T", item[1]))
            else:
                stages.append((item[0], next(it), item[1]))
        return cls(n, stages)


def _register_plan_pytree():
    from jax.tree_util import register_pytree_node

    register_pytree_node(
        PermutePlan,
        lambda p: p.tree_flatten(),
        lambda aux, children: PermutePlan.tree_unflatten(aux, children),
    )


_register_plan_pytree()


def _rowsel_shuffle_enabled():
    import os

    return os.environ.get("GRAPHBLAS_TPU_ROWSEL_SHUFFLE") == "1"


def padded_size(e):
    """Smallest admissible network size >= e.  Admissible: rows r = m * 128^L
    with 1 <= m <= 128, size = r * 128."""
    r0 = max(1, -(-e // 128))
    L = 0
    while 128 ** (L + 1) < r0:
        L += 1
    m = -(-r0 // (128**L))
    return m * (128**L) * 128


def _shape_params(n):
    r = n // 128
    L = 0
    m = r
    while m > 128:
        if m % 128:
            raise ValueError(f"{n} is not an admissible network size; use padded_size")
        m //= 128
        L += 1
    return r, m, L


def _t_slotmap(n, level):
    """The (self-inverse) slot permutation of transpose stage T_level."""
    M = 128**level
    q = n // (128 * M * 128)
    p = np.arange(n)
    b = p % 128
    mm = (p // 128) % M
    a = (p // (128 * M)) % 128
    qq = p // (128 * M * 128)
    return ((qq * 128 + b) * M + mm) * 128 + a


def _apply_S_np(elem, idx):
    r = idx.shape[0]
    e2 = elem.reshape(r, 128)
    return np.take_along_axis(e2, idx.astype(np.int32), axis=1).reshape(-1)


def _apply_T_np(elem, n, level):
    M = 128**level
    q = n // (128 * M * 128)
    return (
        elem.reshape(q, 128, M, 128).transpose(0, 3, 2, 1).reshape(-1)
    )


def _rowsel_table(src_top, m):
    """Lane-shuffle table realizing a ROWSEL (m-way row exchange) in the
    axis-rotated layout.

    ROWSEL moves whole 128-lane rows between the m top-digit groups:
    out[g, s, l] = x[st[g, s, l], s, l].  Rotating the array to (s, l, m)
    puts the m-axis on lanes (m | 128), where the exchange becomes a
    per-row 128-lane shuffle — the network's fast primitive — bounded at
    3 passes TOTAL (rotate, shuffle, rotate back) instead of the m+1
    passes of an m-way select.  Returns the (n//128, 128) int8 table.
    """
    st = np.asarray(src_top)
    m_, s2, _ = st.shape
    assert m_ == m
    n = m * s2 * 128
    rows = n // 128
    r = np.arange(rows, dtype=np.int64)[:, None]
    p = np.arange(128, dtype=np.int64)[None, :]
    flat = r * 128 + p
    s_ix = flat // (128 * m)
    rem = flat % (128 * m)
    l_ix = rem // m
    g_ix = rem % m
    lane = (p // m) * m + st[g_ix, s_ix, l_ix]
    return lane.astype(np.int8)


def _rowsel_unshuffle(shuf, m):
    """Invert ``_rowsel_table``: recover the (m, s2, 128) src_top select
    table from a saved lane-shuffle table (r3 plan-cache compat)."""
    shuf = np.asarray(shuf)
    rows = shuf.shape[0]
    n = rows * 128
    s2 = n // (128 * m)
    r = np.arange(rows, dtype=np.int64)[:, None]
    p = np.arange(128, dtype=np.int64)[None, :]
    flat = r * 128 + p
    s_ix = flat // (128 * m)
    rem = flat % (128 * m)
    l_ix = rem // m
    g_ix = rem % m
    st = np.empty((m, s2, 128), np.int32)
    st[g_ix, s_ix, l_ix] = shuf.astype(np.int64) - (p // m) * m
    return st


def _apply_RSEL_np(elem, src_top, m):
    s2 = src_top.shape[1]
    e3 = elem.reshape(m, s2, 128)
    return np.take_along_axis(e3, src_top.astype(np.int64), axis=0).reshape(-1)


def _apply_ROWSEL_np(elem, shuf, m):
    """Numpy application of the rotated-layout ROWSEL shuffle table."""
    n = elem.shape[0]
    s2 = n // (128 * m)
    t = np.ascontiguousarray(elem.reshape(m, s2, 128).transpose(1, 2, 0)).reshape(-1, 128)
    t = np.take_along_axis(t, shuf.astype(np.int64), axis=1)
    return np.ascontiguousarray(t.reshape(s2, 128, m).transpose(2, 0, 1)).reshape(-1)


def plan_to_device(plan):
    """Commit a plan's routing tables to the device.  A freshly built plan
    holds numpy tables; passing it as a jit ARGUMENT would re-upload them on
    every call."""
    import jax.numpy as jnp

    stages = []
    for s in plan.stages:
        if s[0] == "S":
            stages.append(("S", jnp.asarray(s[1])))
        elif s[0] == "T":
            stages.append(s)
        else:
            stages.append((s[0], jnp.asarray(s[1]), s[2]))
    return PermutePlan(plan.n, stages)


def _euler_color_strided(out_row, r, stride):
    """128-edge-coloring for a forward S-stage at level > 0: both endpoints of
    every edge agree mod ``stride`` (out_row = hi * stride + cur_row % stride),
    so the problem decomposes into ``stride`` INDEPENDENT colorings of
    r//stride rows each — small enough to stay cache-resident, where the
    Euler-split walk runs ~20x faster than at full size.  cur_row is the
    static slot//128 pattern.  Returns colors in slot order."""
    E = len(out_row)
    rs = r // stride
    # slot order is row-major; rows cycle groups with period ``stride`` —
    # group-major regrouping is a pure reshape/transpose
    out_g = (
        np.ascontiguousarray(
            out_row.reshape(rs, stride, 128).transpose(1, 0, 2)
        ).reshape(-1)
        // stride
    ).astype(np.int32)
    in_local = np.repeat(np.arange(rs, dtype=np.int32), 128)
    seglen = rs * 128
    colors_g = euler_color_batched(in_local, out_g, seglen, rs)
    return np.ascontiguousarray(
        colors_g.reshape(stride, rs, 128).transpose(1, 0, 2)
    ).reshape(-1)


def build_permutation_plan(perm, *, validate=True):
    """Build a network plan computing out[p] = in[perm[p]].

    ``perm`` must be a true permutation of an admissible size (use
    ``padded_size`` + identity-extend to pad).
    """
    perm = np.asarray(perm, np.int64)
    n = len(perm)
    r, m, L = _shape_params(n)
    if n < (1 << 31) and not _rowsel_shuffle_enabled():
        # fused native build (one pass per level per side instead of ~8
        # numpy full-array passes; colorings run inline) — same stages,
        # verified in-kernel (routing collisions and a final elem==perm
        # check fail the call)
        from ..native import build_network

        built = build_network(perm, L, m)
        if built is not None:
            s_tables, rsel = built
            stages = []
            for lvl in range(L + 1):
                stages.append(("S", s_tables[lvl]))
                if lvl < L:
                    stages.append(("T", lvl))
                else:
                    stages.append(("RSEL", rsel, m))
            stages.append(("S", s_tables[L + 1]))
            for lvl in range(L - 1, -1, -1):
                stages.append(("T", lvl))
                stages.append(("S", s_tables[L + 1 + (L - lvl)]))
            return PermutePlan(n, stages)
    idt = np.int32 if n < (1 << 31) else np.int64
    # target slot per element (element id = source slot)
    t = np.empty(n, idt)
    t[perm] = np.arange(n, dtype=idt)
    elem = np.arange(n, dtype=idt)
    stages = []
    slots = np.arange(n, dtype=idt)
    lanes_all = slots % 128
    rows_all = slots // 128

    # ---- forward: S_pre (+ T) per level; base ROWSEL -----------------------
    for lvl in range(L + 1):
        stride = 128**lvl
        te = t[elem]
        cur_row = rows_all
        out_row = (te // (128 ** (lvl + 1))) * stride + cur_row % stride
        if stride > 1:
            colors = _euler_color_strided(out_row, r, stride)
        else:
            colors = euler_color(cur_row.astype(np.int32), out_row.astype(np.int32), r, 128)
        idx = np.full((r, 128), -1, np.int16)
        idx[cur_row, colors] = lanes_all.astype(np.int16)
        if validate and (idx < 0).any():
            raise AssertionError("invalid coloring: lane collision")
        idx = idx.astype(np.int8)  # lanes < 128: int8 tables = 4x less traffic
        stages.append(("S", idx))
        elem = _apply_S_np(elem, idx)
        if lvl < L:
            stages.append(("T", lvl))
            elem = _apply_T_np(elem, n, lvl)
        else:
            te = t[elem]
            dest_row = (te // (128 ** (lvl + 1))) * stride + rows_all % stride
            src = np.full((r, 128), -1, np.int32)
            src[dest_row, lanes_all] = rows_all.astype(np.int32)
            if validate and (src < 0).any():
                raise AssertionError("invalid routing: row collision in ROWSEL")
            # rows differ only in top digit: m-way row select (RSEL).  The
            # rotate+lane-shuffle ROWSEL form needs (m,s2,128)<->(s2,128,m)
            # relayouts around the shuffle; it stays available for
            # experiments behind GRAPHBLAS_TPU_ROWSEL_SHUFFLE=1.
            src_top = (src // stride).reshape(m, stride, 128).astype(np.int32)
            if _rowsel_shuffle_enabled() and 128 % m == 0:
                shuf = _rowsel_table(src_top, m)
                stages.append(("ROWSEL", shuf, m))
                elem = _apply_ROWSEL_np(elem, shuf, m)
            else:
                stages.append(("RSEL", src_top, m))
                elem = _apply_RSEL_np(elem, src_top, m)

    # ---- backward: S_post fixes the level's lane digit; T's unwind ----------
    # S_post at level lvl routes each element to lane (t // 128^lvl) % 128;
    # the forward routing guarantees it is already in the right row.
    back = [("S_post", L)]
    for lvl in range(L - 1, -1, -1):
        back.append(("T", lvl))
        back.append(("S_post", lvl))
    for stage in back:
        if stage[0] == "T":
            stages.append(("T", stage[1]))
            elem = _apply_T_np(elem, n, stage[1])
        else:
            lvl = stage[1]
            req_lane = (t[elem] // (128**lvl)) % 128
            idx = np.full((r, 128), -1, np.int16)
            idx[rows_all, req_lane] = lanes_all.astype(np.int16)
            if validate and (idx < 0).any():
                raise AssertionError(f"invalid S_post table at level {lvl}")
            idx = idx.astype(np.int8)
            stages.append(("S", idx))
            elem = _apply_S_np(elem, idx)

    if validate and not np.array_equal(elem, perm):
        raise AssertionError("permutation plan does not reproduce the permutation")
    return PermutePlan(n, stages)


# ---------------------------------------------------------------------------
# Runtime application
# ---------------------------------------------------------------------------


def apply_plan(x, plan):
    """Apply a PermutePlan to a flat device array (out[p] = in[perm[p]]).

    Each S stage is a gather within 128-wide rows (``take_along_axis``), each
    T stage a reshape-transpose; XLA fuses them into coalesced passes."""
    import jax.numpy as jnp

    n = plan.n
    for stage in plan.stages:
        kind = stage[0]
        if kind == "S":
            idx = jnp.asarray(stage[1])
            x2d = x.reshape(n // 128, 128)
            x = jnp.take_along_axis(x2d, idx.astype(jnp.int32), axis=1).reshape(-1)
        elif kind == "T":
            level = stage[1]
            M = 128**level
            q = n // (128 * M * 128)
            x = x.reshape(q, 128, M, 128).transpose(0, 3, 2, 1).reshape(-1)
        elif kind == "RSEL":  # m-way row select (m does not divide 128)
            src_top, m = stage[1], stage[2]
            s2 = src_top.shape[1]
            x3 = x.reshape(m, s2, 128)
            st = jnp.asarray(src_top)
            if m <= 16:
                acc = jnp.zeros((m, s2, 128), x.dtype)
                for j in range(m):
                    acc = jnp.where(st == j, x3[j][None, :, :], acc)
                x = acc.reshape(-1)
            else:
                x = jnp.take_along_axis(x3, st.astype(jnp.int32), axis=0).reshape(-1)
        else:  # ROWSEL: rotate m onto lanes, per-row shuffle, rotate back
            shuf, m = stage[1], stage[2]
            if m > 1:
                s2 = n // (128 * m)
                t = x.reshape(m, s2, 128).transpose(1, 2, 0).reshape(-1, 128)
                t = jnp.take_along_axis(t, jnp.asarray(shuf).astype(jnp.int32), axis=1)
                x = t.reshape(s2, 128, m).transpose(2, 0, 1).reshape(-1)
    return x
