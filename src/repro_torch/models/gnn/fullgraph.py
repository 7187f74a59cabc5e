"""Subgraph / full-graph GNN execution (`repro/models/gnn/fullgraph.py`):
ClusterGCN batches and the full-batch training baseline of paper §2.

Unlike the sampled tower (`apply_gnn`), these run L layers over ONE node
set with an explicit padded edge list. The reference aggregates with
`segment_sum` over that list; on CUDA the PyTorch equivalents
(`index_add_`, `scatter_add_`) are atomic, so their sums change from run
to run. The port aggregates on the `gather_agg` kernels instead, in two
deterministic steps over a table built once per batch on the host
(`neighbor_chunks`):

  1. the destination-major edge list is cut into virtual rows of `CHUNK`
     slots (a destination's edges in list order, its last row padded with
     weight-0 slots that name the destination itself), and `gather_mean`
     takes each virtual row's mean;
  2. `segment_sum_sorted` adds each destination's virtual-row means,
     weighted by their share of its edges, into its row (the sort-free
     scatter-add kernel: the owners are non-decreasing).

A padded (n, max degree) table would hold 1.57 G slots for reddit-602's
full graph (max degree 6,720, mean 49.3): the virtual rows pad at most
`CHUNK - 1` slots a destination. The backward is the bwd_dx kernel over
the virtual rows, one `DxPlan` (one sort) shared by every layer and step
on the batch, and a row gather: a relaunch is bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import GNNConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.kernels.gather_agg.ops import DxPlan, segment_sum_sorted
from repro_torch.kernels.gather_mean.ops import gather_mean

CHUNK = 32      # slots of a virtual row


def neighbor_chunks(edge_src: np.ndarray, edge_dst: np.ndarray,
                    edge_mask: np.ndarray, num_rows: int,
                    width: int = CHUNK):
    """The valid edges of a list, destination-major (list order within a
    destination), cut into virtual rows of `width` slots: `nbr` (V, width)
    int32 source positions, `nbr_mask` (V, width) bool, `owner` (V,) int32
    the destination of each virtual row (non-decreasing), `share` (V,)
    float32 its edges over its destination's. Destinations without edges
    own no virtual row."""
    m = np.asarray(edge_mask, bool)
    es = np.asarray(edge_src, np.int64)[m]
    ed = np.asarray(edge_dst, np.int64)[m]
    order = np.argsort(ed, kind="stable")
    es, ed = es[order], ed[order]
    counts = np.bincount(ed, minlength=num_rows)
    chunks = -(-counts // width)
    owner = np.repeat(np.arange(num_rows, dtype=np.int32), chunks)
    first_chunk = np.cumsum(chunks) - chunks
    k = np.arange(len(ed)) - (np.cumsum(counts) - counts)[ed]
    slot = first_chunk[ed] * width + k        # row-major (V, width) slot
    nbr = np.repeat(owner, width)
    nbr_mask = np.zeros(len(nbr), bool)
    nbr[slot] = es
    nbr_mask[slot] = True
    nbr, nbr_mask = nbr.reshape(-1, width), nbr_mask.reshape(-1, width)
    share = (nbr_mask.sum(axis=1).astype(np.float32)
             / counts[owner].astype(np.float32))
    return nbr, nbr_mask, owner, share


@dataclass
class SubgraphBatch:
    nodes: torch.Tensor       # (cap_n,) int32 node ids (sentinel-padded)
    node_mask: torch.Tensor   # (cap_n,) bool
    edge_src: torch.Tensor    # (cap_e,) int32 positions into nodes
    edge_dst: torch.Tensor    # (cap_e,) int32
    edge_mask: torch.Tensor   # (cap_e,) bool
    labels: torch.Tensor      # (cap_n,) int32
    loss_mask: torch.Tensor   # (cap_n,) bool train-root indicator
    nbr: torch.Tensor         # (V, CHUNK) int32 `neighbor_chunks`
    nbr_mask: torch.Tensor    # (V, CHUNK) bool
    owner: torch.Tensor       # (V,) int32, non-decreasing
    share: torch.Tensor       # (V,) float32
    _plan: Optional[DxPlan] = None

    @staticmethod
    def from_arrays(nodes, node_mask, edge_src, edge_dst, edge_mask, labels,
                    loss_mask, device: DeviceLike = None) -> "SubgraphBatch":
        """The batch of the reference's seven numpy fields, with the
        virtual rows built on the host, uploaded to `device` (the CUDA
        device unless the caller passes another)."""
        dev = resolve_device(device)
        chunks = neighbor_chunks(edge_src, edge_dst, edge_mask, len(nodes))

        def t(a, dtype):
            a = np.ascontiguousarray(a, dtype=dtype)
            return torch.from_numpy(a).to(dev)

        i32, b = np.int32, np.bool_
        return SubgraphBatch(
            t(nodes, i32), t(node_mask, b), t(edge_src, i32),
            t(edge_dst, i32), t(edge_mask, b), t(labels, i32),
            t(loss_mask, b), t(chunks[0], i32), t(chunks[1], b),
            t(chunks[2], i32), t(chunks[3], np.float32))

    def dx_plan(self) -> DxPlan:
        """The `DxPlan` of `nbr` over the batch's rows, made once per
        batch: every backward over the batch (each layer, each step)
        shares its one sort."""
        if self._plan is None:
            self._plan = DxPlan(self.nbr, self.nodes.shape[0])
        return self._plan


def sage_subgraph_apply(cfg: GNNConfig, params, batch: SubgraphBatch, x, *,
                        train: bool = False,
                        dropout_gens: Optional[List[torch.Generator]] = None):
    """Mean-aggregator SAGE over the batch's edges. x: (cap_n, in_dim),
    row i the features of `batch.nodes[i]`; params: the port's `GNN` of
    `SageLayer`s. `dropout_gens[i]` draws layer i's dropout mask
    (training only). Returns (cap_n, num_classes) logits."""
    if cfg.model != "sage":
        raise ValueError(f"subgraph execution is SAGE's, not {cfg.model!r}")
    node_mask = batch.node_mask[:, None].to(x.dtype)
    plan = batch.dx_plan()
    x = x * node_mask
    L = len(params.layers)
    n = x.shape[0]
    for i, p in enumerate(params.layers):
        part = gather_mean(x, batch.nbr, batch.nbr_mask, plan)
        mean = segment_sum_sorted(part, batch.owner, batch.share,
                                  n).to(x.dtype)
        x = x @ p.w_self + mean @ p.w_neigh + p.b
        if i < L - 1:
            x = torch.relu(x)
            if train and cfg.dropout > 0 and dropout_gens is not None:
                keep = 1.0 - cfg.dropout
                u = torch.rand(x.shape, generator=dropout_gens[i],
                               device=x.device)
                x = torch.where(u < keep, x / keep, 0.0)
        x = x * node_mask
    return x
