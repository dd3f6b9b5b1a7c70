"""Graph algorithm models vs host-side oracles (the acceptance workloads)."""

import heapq

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.models import (
    Graph,
    bfs_level,
    bfs_parent,
    connected_components,
    pagerank,
    sssp,
    triangle_count,
)
from graphblas_tpu.models.graph import rmat


@pytest.fixture(scope="module")
def random_graph():
    rng = np.random.default_rng(7)
    n, e = 60, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) * 9 + 1).astype(np.float32)
    return Graph.from_arrays(src, dst, w, n=n), src, dst, w, n


def _adj(src, dst, w=None):
    adj = {}
    for i in range(len(src)):
        adj.setdefault(int(src[i]), []).append((int(dst[i]), float(w[i]) if w is not None else 1.0))
    return adj


def test_bfs_level(random_graph):
    g, src, dst, w, n = random_graph
    levels = np.asarray(bfs_level(g, 0))
    # oracle BFS
    adj = _adj(src, dst)
    expected = -np.ones(n, np.int64)
    expected[0] = 0
    frontier = [0]
    depth = 0
    while frontier:
        depth += 1
        nxt = []
        for u in frontier:
            for v, _ in adj.get(u, []):
                if expected[v] < 0:
                    expected[v] = depth
                    nxt.append(v)
        frontier = nxt
    np.testing.assert_array_equal(levels, expected)


def test_bfs_parent(random_graph):
    g, src, dst, w, n = random_graph
    parents = np.asarray(bfs_parent(g, 0))
    levels = np.asarray(bfs_level(g, 0))
    edge_set = set(zip(src.tolist(), dst.tolist()))
    assert parents[0] == 0
    for v in range(n):
        if v == 0:
            continue
        if levels[v] < 0:
            assert parents[v] == -1
        else:
            p = parents[v]
            assert (p, v) in edge_set
            assert levels[p] == levels[v] - 1


def test_sssp(random_graph):
    g, src, dst, w, n = random_graph
    dist = np.asarray(sssp(g, 0))
    adj = _adj(src, dst, w)
    INF = float("inf")
    d = [INF] * n
    d[0] = 0.0
    pq = [(0.0, 0)]
    while pq:
        du, u = heapq.heappop(pq)
        if du > d[u]:
            continue
        for v, wt in adj.get(u, []):
            if du + wt < d[v]:
                d[v] = du + wt
                heapq.heappush(pq, (d[v], v))
    for i in range(n):
        if d[i] == INF:
            assert dist[i] > 1e37
        else:
            assert np.isclose(dist[i], d[i], rtol=1e-5)


def test_sssp_as_vector(random_graph):
    from graphblas_tpu.core import dtypes as dtm

    g, *_ = random_graph
    v = sssp(g, 0, as_vector=True)
    # platform-adaptive output dtype: FP64 under the 64-bit policy, else FP32
    # (the 64-bit execution contract, docs/types.md)
    assert v.dtype is dtm.default_float()
    assert v[0].new().value == 0.0


def test_pagerank(random_graph):
    g, src, dst, w, n = random_graph
    r = np.asarray(pagerank(g, tol=1e-10))
    assert np.isclose(r.sum(), 1.0, atol=1e-4)
    # numpy power-iteration oracle
    M = np.zeros((n, n))
    for i in range(len(src)):
        M[dst[i], src[i]] += 1.0
    outdeg = np.zeros(n)
    for i in range(len(src)):
        outdeg[src[i]] += 1
    col = np.where(outdeg > 0, outdeg, 1)
    M = M / col[None, :]
    x = np.full(n, 1.0 / n)
    d = 0.85
    for _ in range(200):
        dangling = x[outdeg == 0].sum()
        x = (1 - d) / n + d * (M @ x + dangling / n)
    np.testing.assert_allclose(r, x, rtol=1e-3, atol=1e-6)


def test_connected_components():
    # two components: {0,1,2}, {3,4}; 5 isolated
    src = np.array([0, 1, 3], np.int32)
    dst = np.array([1, 2, 4], np.int32)
    g = Graph.from_arrays(src, dst, n=6)
    f = np.asarray(connected_components(g))
    assert f[0] == f[1] == f[2]
    assert f[3] == f[4]
    assert f[0] != f[3]
    assert f[5] not in (f[0], f[3])


def test_connected_components_random(random_graph):
    g, src, dst, w, n = random_graph
    f = np.asarray(connected_components(g))
    # union-find oracle (undirected)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(len(src)):
        a, b = find(int(src[i])), find(int(dst[i]))
        if a != b:
            parent[a] = b
    roots = [find(i) for i in range(n)]
    # same partition?
    for i in range(n):
        for j in range(i + 1, n):
            assert (f[i] == f[j]) == (roots[i] == roots[j])


def test_triangle_count():
    # K4 has 4 triangles
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    src, dst = zip(*edges)
    g = Graph.from_arrays(np.array(src, np.int32), np.array(dst, np.int32), n=4)
    assert triangle_count(g) == 4


def test_triangle_count_random(random_graph):
    g, src, dst, w, n = random_graph
    got = triangle_count(g)
    A = np.zeros((n, n), bool)
    A[src, dst] = True
    A |= A.T
    np.fill_diagonal(A, False)
    Ai = A.astype(np.int64)
    expected = int(np.trace(Ai @ Ai @ Ai) // 6)
    assert got == expected


def test_from_matrix_roundtrip(random_graph):
    g, *_ = random_graph
    A = g.to_matrix()
    g2 = Graph.from_matrix(A)
    assert g2.n == g.n
    l1 = np.asarray(bfs_level(g, 0))
    l2 = np.asarray(bfs_level(g2, 0))
    np.testing.assert_array_equal(l1, l2)


def test_rmat_runs():
    g = rmat(8, 4, seed=1)
    assert g.n == 256
    # pick a high-out-degree source (node 0 may be isolated after permutation)
    src = np.asarray(g.src)[np.asarray(g.valid)]
    source = int(np.bincount(src, minlength=g.n).argmax())
    levels = np.asarray(bfs_level(g, source))
    assert (levels >= 0).sum() > 1
    r = np.asarray(pagerank(g, max_iters=20))
    assert np.isfinite(r).all()


def test_louvain_two_communities():
    from graphblas_tpu.models import louvain

    # two dense cliques connected by one edge
    edges = []
    for i in range(5):
        for j in range(i + 1, 5):
            edges.append((i, j))
            edges.append((i + 5, j + 5))
    edges.append((0, 5))
    src, dst = zip(*edges)
    g = Graph.from_arrays(np.array(src, np.int32), np.array(dst, np.int32), n=10)
    labels = np.asarray(louvain(g))
    assert len(set(labels[:5].tolist())) == 1
    assert len(set(labels[5:].tolist())) == 1
    assert labels[0] != labels[5]


def test_fast_models_match_reference_models(rng):
    """fast.* (permutation-network SpMV) vs the segment-kernel models."""
    from graphblas_tpu.models import fast as mf
    from graphblas_tpu.ops import edgewise as ew
    import jax.numpy as jnp

    n, e = 120, 600
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) * 9 + 1).astype(np.float32)
    g = Graph.from_arrays(src, dst, w, n=n)
    plan = mf.analyze(g)
    source = int(np.bincount(src, minlength=n).argmax())

    lv_ref = np.asarray(bfs_level(g, source))
    lv_fast = np.asarray(mf.bfs_level(plan, source, n))
    np.testing.assert_array_equal(lv_fast, lv_ref)

    d_ref = np.asarray(sssp(g, source))
    d_fast = np.asarray(mf.sssp(plan, source, n))
    reach = d_ref < 1e37
    np.testing.assert_allclose(d_fast[reach], d_ref[reach], rtol=1e-5)
    assert (d_fast[~reach] > 1e37).all()

    outdeg = jnp.asarray(np.bincount(src, minlength=n).astype(np.int32))
    r_ref = np.asarray(pagerank(g, tol=0.0, max_iters=30))
    r_fast = np.asarray(mf.pagerank(plan, outdeg, n, tol=0.0, max_iters=30))
    np.testing.assert_allclose(r_fast, r_ref, rtol=1e-4, atol=1e-7)

    p_fast = np.asarray(mf.bfs_parent(plan, source, n))
    lv = lv_ref
    edge_set = set(zip(src.tolist(), dst.tolist()))
    assert p_fast[source] == source
    for v in range(n):
        if v == source:
            continue
        if lv[v] < 0:
            assert p_fast[v] == -1
        else:
            assert (p_fast[v], v) in edge_set
            assert lv[p_fast[v]] == lv[v] - 1


def test_betweenness_centrality_vs_networkx():
    nx = pytest.importorskip("networkx")
    from graphblas_tpu.models import betweenness_centrality

    rng = np.random.default_rng(3)
    n = 40
    src = rng.integers(0, n, 200).astype(np.int32)
    dst = rng.integers(0, n, 200).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    g = Graph.from_arrays(src, dst, n=n)
    bc = np.asarray(betweenness_centrality(g))
    G = nx.DiGraph()
    G.add_nodes_from(range(n))
    G.add_edges_from(zip(src.tolist(), dst.tolist()))
    ref = nx.betweenness_centrality(G, normalized=False)
    assert np.allclose(bc, [ref[i] for i in range(n)], atol=1e-3)
    # sampled-sources variant returns a per-vertex partial sum
    assert np.asarray(betweenness_centrality(g, sources=[0, 5, 7])).shape == (n,)


def test_betweenness_centrality_undirected_convention():
    nx = pytest.importorskip("networkx")
    from graphblas_tpu.models import betweenness_centrality

    rng = np.random.default_rng(11)
    n = 30
    src = rng.integers(0, n, 120).astype(np.int32)
    dst = rng.integers(0, n, 120).astype(np.int32)
    keep = src != dst
    und = np.unique(
        np.stack([np.minimum(src[keep], dst[keep]), np.maximum(src[keep], dst[keep])], 1), axis=0
    )
    g = Graph.from_arrays(
        np.concatenate([und[:, 0], und[:, 1]]).astype(np.int32),
        np.concatenate([und[:, 1], und[:, 0]]).astype(np.int32),
        n=n,
    )
    bc = np.asarray(betweenness_centrality(g)) / 2.0
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(und.tolist())
    ref = nx.betweenness_centrality(G, normalized=False)
    assert np.allclose(bc, [ref[i] for i in range(n)], atol=1e-3)


def test_k_truss_vs_networkx():
    nx = pytest.importorskip("networkx")
    from graphblas_tpu.models import k_truss

    rng = np.random.default_rng(3)
    n = 40
    src = rng.integers(0, n, 200).astype(np.int32)
    dst = rng.integers(0, n, 200).astype(np.int32)
    keep = src != dst
    und = np.unique(
        np.stack([np.minimum(src[keep], dst[keep]), np.maximum(src[keep], dst[keep])], 1), axis=0
    )
    g = Graph.from_arrays(und[:, 0].astype(np.int32), und[:, 1].astype(np.int32), n=n)
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(und.tolist())
    for k in (3, 4, 5):
        kt = k_truss(g, k)
        s = np.asarray(kt.src)[np.asarray(kt.valid)]
        d = np.asarray(kt.dst)[np.asarray(kt.valid)]
        mine = {(a, b) for a, b in zip(s.tolist(), d.tolist()) if a < b}
        theirs = {(min(a, b), max(a, b)) for a, b in nx.k_truss(G, k).edges()}
        assert mine == theirs, k
    with pytest.raises(ValueError):
        k_truss(g, 2)


def test_maximal_matching():
    from graphblas_tpu.models import maximal_matching

    rng = np.random.default_rng(5)
    n = 50
    src = rng.integers(0, n, 250).astype(np.int32)
    dst = rng.integers(0, n, 250).astype(np.int32)
    g = Graph.from_arrays(src, dst, n=n)
    for seed in (0, 1, 2):
        matched = np.asarray(maximal_matching(g, seed=seed))
        s = np.asarray(g.src)
        d = np.asarray(g.dst)
        valid = np.asarray(g.valid)
        ms, md = s[matched], d[matched]
        # it's a matching: each vertex in at most one matched edge
        touched = np.concatenate([ms, md])
        assert len(touched) == len(np.unique(touched))
        # maximal: every live edge has a matched endpoint
        used = np.zeros(n, bool)
        used[ms] = True
        used[md] = True
        live = valid & (s != d)
        assert (used[s[live]] | used[d[live]]).all()


def test_seed_round_ab_and_edge_sources(monkeypatch):
    """The init-seed (relax the source's out-edges as one scan pass,
    models/fast._seed_state) must be a pure round-count optimization:
    identical levels/distances with GRAPHBLAS_TPU_SEED_ROUND=0/1 across
    every x_start mode, including sources with no out-edges, no in-edges
    (no state slot), self-loops, and isolated vertices."""
    from graphblas_tpu.models import fast as mf

    rng = np.random.default_rng(11)
    n, e = 90, 400
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    # engineered corners: vertex 80 sink (no out), 81 source-only (no in),
    # 82 self-loop only, 83 isolated
    keep = ~np.isin(src, [80, 82, 83]) & ~np.isin(dst, [81, 82, 83])
    src, dst = src[keep], dst[keep]
    src = np.concatenate([src, [82]]).astype(np.int32)
    dst = np.concatenate([dst, [82]]).astype(np.int32)
    w = (rng.random(len(src)) * 9 + 1).astype(np.float32)
    g = Graph.from_arrays(src, dst, w, n=n)
    plan = mf.analyze(g)
    sources = [int(np.bincount(src, minlength=n).argmax()), 80, 81, 82, 83]

    ref = {}
    monkeypatch.setenv("GRAPHBLAS_TPU_SEED_ROUND", "0")
    for s in sources:
        ref[s] = (np.asarray(mf.bfs_level(plan, s, n)), np.asarray(mf.sssp(plan, s, n)))
        np.testing.assert_array_equal(ref[s][0], np.asarray(bfs_level(g, s)))
    monkeypatch.setenv("GRAPHBLAS_TPU_SEED_ROUND", "1")
    for mode in ("select", "donor", "donor_state", "fused", "donor_post"):
        monkeypatch.setenv("GRAPHBLAS_TPU_XSTART_MODE", mode)
        for s in sources:
            np.testing.assert_array_equal(np.asarray(mf.bfs_level(plan, s, n)), ref[s][0], err_msg=f"bfs {mode} {s}")
            np.testing.assert_allclose(np.asarray(mf.sssp(plan, s, n)), ref[s][1], rtol=1e-5, err_msg=f"sssp {mode} {s}")
