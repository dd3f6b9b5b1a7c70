"""The compiled algorithm library: whole graph algorithms as single XLA
programs (FastSV connected components, Louvain, triangle count, and the
permutation-network fast path).

The interactive DSL (examples 01-05) dispatches one engine call per
statement, like the reference; `graphblas_tpu.models` is the compiled way
to run the same recipes at full speed.
"""

import numpy as np

from graphblas_tpu.models import (
    Graph,
    bfs_level,
    connected_components,
    louvain,
    pagerank,
    sssp,
    triangle_count,
)
from graphblas_tpu.models.graph import rmat

g = rmat(10, 8, seed=7, weighted=True)  # 1024 nodes, ~8k edges
src = np.asarray(g.src)[np.asarray(g.valid)]
source = int(np.bincount(src, minlength=g.n).argmax())

levels = np.asarray(bfs_level(g, source))
print(f"BFS: reached {(levels >= 0).sum()} nodes in {levels.max()} levels")

dist = np.asarray(sssp(g, source))
print(f"SSSP: {np.isfinite(dist[dist < 1e37]).sum()} reachable, max dist {dist[dist < 1e37].max():.2f}")

r = np.asarray(pagerank(g, tol=1e-8))
print(f"PageRank: sum={r.sum():.6f}, top node {int(r.argmax())}")

comps = np.asarray(connected_components(g))
print(f"Connected components: {len(np.unique(comps))}")

tc = triangle_count(g)
print(f"Triangles: {tc}")

# Louvain on a small clustered graph
edges = []
for b in range(4):
    for i in range(8):
        for j in range(i + 1, 8):
            edges.append((b * 8 + i, b * 8 + j))
edges += [(0, 8), (8, 16), (16, 24)]
s2, d2 = zip(*edges)
clustered = Graph.from_arrays(np.array(s2, np.int32), np.array(d2, np.int32), n=32)
labels = np.asarray(louvain(clustered))
print(f"Louvain: {len(np.unique(labels))} communities over 4 planted cliques")
assert len(np.unique(labels)) == 4
print("Compiled models OK")
