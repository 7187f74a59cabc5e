"""CSR graph substrate: the host-side numpy `Graph` (copied from
`repro/graphs/csr.py`) and its device mirror on torch tensors.

The device mirror stores the *intra-first* row layout: each adjacency row is
re-ordered so intra-community edges come first and `n_intra[u]` records the
split point — this turns the paper's biased neighbor sampling (probability p
for intra-community edges) into a two-phase draw with O(1) per-sample work
and no per-edge weight array.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device


@dataclass
class Graph:
    indptr: np.ndarray           # (N+1,) int64
    indices: np.ndarray          # (E,) int32
    features: np.ndarray         # (N, F) float32
    labels: np.ndarray           # (N,) int32
    train_ids: np.ndarray
    val_ids: np.ndarray
    test_ids: np.ndarray
    communities: Optional[np.ndarray] = None   # (N,) int32
    n_intra: Optional[np.ndarray] = None       # (N,) int32 (intra-first rows)
    name: str = "graph"

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def symmetrize(indptr, indices):
    """Make the graph undirected (union with reverse edges), dedup."""
    N = len(indptr) - 1
    src = np.repeat(np.arange(N, dtype=np.int64), np.diff(indptr))
    dst = indices.astype(np.int64)
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    key = u * N + v
    key = np.unique(key)
    u, v = key // N, (key % N).astype(np.int32)
    new_indptr = np.zeros(N + 1, np.int64)
    np.add.at(new_indptr, u + 1, 1)
    np.cumsum(new_indptr, out=new_indptr)
    return new_indptr, v


def reorder(graph: Graph, perm: np.ndarray) -> Graph:
    """Relabel nodes: new_id = perm_inv[old_id]; node `perm[i]` becomes `i`."""
    N = graph.num_nodes
    perm_inv = np.empty(N, np.int64)
    perm_inv[perm] = np.arange(N)
    old_deg = graph.degrees()
    new_indptr = np.zeros(N + 1, np.int64)
    np.cumsum(old_deg[perm], out=new_indptr[1:])
    # vectorized row move: edge e of old node u keeps its within-row offset
    # and lands at new row perm_inv[u]
    src = np.repeat(np.arange(N, dtype=np.int64), old_deg)
    offs = np.arange(graph.num_edges, dtype=np.int64) - graph.indptr[src]
    new_indices = np.empty_like(graph.indices)
    new_indices[new_indptr[perm_inv[src]] + offs] = perm_inv[graph.indices]
    return replace(
        graph,
        indptr=new_indptr,
        indices=new_indices.astype(np.int32),
        features=graph.features[perm],
        labels=graph.labels[perm],
        train_ids=np.sort(perm_inv[graph.train_ids]).astype(np.int64),
        val_ids=np.sort(perm_inv[graph.val_ids]).astype(np.int64),
        test_ids=np.sort(perm_inv[graph.test_ids]).astype(np.int64),
        communities=graph.communities[perm]
        if graph.communities is not None else None,
        n_intra=None,       # row layout must be rebuilt after relabeling
    )


def intra_first_layout(graph: Graph) -> Graph:
    """Reorder each adjacency row: intra-community neighbors first."""
    assert graph.communities is not None
    comm = graph.communities
    src = np.repeat(np.arange(graph.num_nodes), graph.degrees())
    intra = comm[src] == comm[graph.indices]
    # stable sort within rows: key = (row, ~intra)
    order = np.lexsort((~intra, src))
    new_indices = graph.indices[order]
    n_intra = np.zeros(graph.num_nodes, np.int32)
    np.add.at(n_intra, src[intra], 1)
    return replace(graph, indices=new_indices, n_intra=n_intra)


@dataclass
class DeviceGraph:
    """int32 tensor mirrors read by the samplers and the batch builder.

    `max_degree` is plain host metadata (the reference keeps it static for
    the LABOR sampler's candidate tile)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    n_intra: torch.Tensor
    communities: torch.Tensor
    degrees: torch.Tensor
    num_nodes: int
    max_degree: int = 0

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @staticmethod
    def from_graph(g: Graph, device: DeviceLike = None) -> "DeviceGraph":
        """Upload `g` (intra-first layout) to `device` — the CUDA device
        unless the caller passes another."""
        dev = resolve_device(device)
        if g.n_intra is None:
            raise ValueError("run intra_first_layout first")
        deg = g.degrees()
        if len(g.indices) >= 2 ** 31:
            raise ValueError("int32 CSR offsets need fewer than 2^31 edges")

        def up(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

        return DeviceGraph(
            indptr=up(g.indptr), indices=up(g.indices), n_intra=up(g.n_intra),
            communities=up(g.communities), degrees=up(deg),
            num_nodes=g.num_nodes,
            max_degree=int(deg.max()) if len(deg) else 0)
