"""Community-based graph reordering (RABBIT-style, paper §3 Figure 1).
A copy of `repro/core/reorder.py` (pure numpy).

Nodes of the same community get consecutive ids; communities are laid out by
size (hot/large first — the degree-ordered flavor of rabbit ordering).
The same module exposes `prepare`, the one-call preprocessing pipeline:
detect (or adopt oracle) communities -> reorder -> intra-first row layout.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.community import louvain
from repro_torch.graphs.csr import Graph, intra_first_layout, reorder


def community_permutation(communities: np.ndarray,
                          degrees: np.ndarray = None) -> np.ndarray:
    """perm[i] = old id of the node that becomes new id i."""
    if degrees is None:
        key = communities.astype(np.int64)
        return np.argsort(key, kind="stable")
    # order communities by total degree (hot communities first), nodes by
    # degree inside each community
    n_comm = communities.max() + 1
    comm_deg = np.zeros(n_comm, np.int64)
    np.add.at(comm_deg, communities, degrees)
    comm_rank = np.empty(n_comm, np.int64)
    comm_rank[np.argsort(-comm_deg, kind="stable")] = np.arange(n_comm)
    return np.lexsort((-degrees, comm_rank[communities]))


def prepare(graph: Graph, *, oracle: bool = True, levels: int = 2,
            seed: int = 0) -> Graph:
    """Full preprocessing: communities -> reorder -> intra-first layout."""
    if graph.communities is None or not oracle:
        comm = louvain(graph.indptr, graph.indices, levels=levels, seed=seed)
        graph = type(graph)(**{**graph.__dict__, "communities": comm})
    perm = community_permutation(graph.communities, graph.degrees())
    g2 = reorder(graph, perm)
    g2 = intra_first_layout(g2)
    return g2


def community_bounds(communities: np.ndarray) -> np.ndarray:
    """For a community-sorted graph: start offsets of each community
    (len n_comm+1)."""
    n_comm = communities.max() + 1
    bounds = np.zeros(n_comm + 1, np.int64)
    np.add.at(bounds, communities + 1, 1)
    np.cumsum(bounds, out=bounds)
    return bounds
