"""Graph algorithm library — the acceptance workloads compiled as single XLA
programs.

These are the reference's notebook algorithms (SURVEY.md §6 / BASELINE.md):
SSSP, PageRank, level & parent BFS, FastSV connected components, triangle
counting.  The interactive DSL dispatches one engine call per statement; these
models instead fuse the whole iteration loop into one ``lax.while_loop`` under
``jit`` — the compiled answer to "create objects outside the loop and reuse
them" (reference README.md:92-116).
"""

from ..core import _init_jax as _init_jax

_init_jax()

from .graph import Graph  # noqa: F401
from .bfs import bfs_level, bfs_parent  # noqa: F401
from .sssp import sssp  # noqa: F401
from .pagerank import pagerank  # noqa: F401
from .fastsv import connected_components  # noqa: F401
from .triangle import triangle_count  # noqa: F401
from .louvain import louvain  # noqa: F401
from .centrality import betweenness_centrality  # noqa: F401
from .ktruss import k_truss  # noqa: F401
from .matching import maximal_matching  # noqa: F401
from . import fast  # noqa: F401
from . import dsl  # noqa: F401
