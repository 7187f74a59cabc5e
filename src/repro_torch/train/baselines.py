"""Prior-work baselines (`repro/train/baselines.py`) for the paper's §6.3
comparison table and the §2 full-batch-vs-mini-batch motivation:

  - ClusterGCN [14]: batches = random unions of graph partitions
    (communities here, as the partitioner); the subgraph is the FULL induced
    subgraph, computed for ALL its nodes — per-epoch cost is invariant to the
    training-set size (paper Fig 8).
  - LABOR-lite [9]: structure-agnostic shared-randomness neighbor sampling
    (`labor_lite_epoch_footprint`, copied numpy; the trainer's path is
    `make_policy("labor")`).
  - full-batch: one gradient step per epoch on the whole graph.

Both trainers aggregate through `gather_mean` on the `gather_agg` kernels
(`models.gnn.fullgraph`), with the port's AdamW and losses. Randomness is
the reference's where it is numpy (ClusterGCN's unions: every epoch's and
then the evaluation's from one `default_rng((seed, 0))`, in its order) and
the port's own elsewhere (parameter init from a CPU generator; dropout
from `cursor_generator(device, seed, epoch, part, layer, SALT_DROPOUT)`).
Entry points run on the CUDA device unless given `device=`.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.batching.policy import ClusterGCNPolicy
from repro_torch.batching.stream import SALT_DROPOUT, cursor_generator
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.graphs.csr import Graph
from repro_torch.models.gnn.fullgraph import (SubgraphBatch,
                                              sage_subgraph_apply)
from repro_torch.models.gnn.models import init_gnn
from repro_torch.optim import adamw
from repro_torch.train.losses import accuracy, gnn_softmax_ce


# ---------------------------------------------------------------------------
# ClusterGCN
# ---------------------------------------------------------------------------
def clustergcn_batches(graph: Graph, parts_per_batch: int,
                       rng: np.random.Generator) -> List[np.ndarray]:
    """Random unions of `parts_per_batch` communities (one epoch) — the
    registered "clustergcn" policy's node grouping."""
    pol = ClusterGCNPolicy(parts_per_batch=parts_per_batch)
    return pol.member_groups(graph.communities, rng)


def induced_subgraph(graph: Graph, nodes: np.ndarray, cap_n: int,
                     cap_e: int, device: DeviceLike = None) -> SubgraphBatch:
    """The subgraph induced by `nodes` (cut to `cap_n`): every edge of each
    node's CSR row whose source is in the set, listed by destination in
    node order, each row in CSR order, the list cut at `cap_e`; the
    reference's per-node loop in one vectorised pass, field for field
    equal."""
    nodes = np.asarray(nodes)[:cap_n]
    pos = np.full(graph.num_nodes, -1, np.int64)
    pos[nodes] = np.arange(len(nodes))
    starts = graph.indptr[nodes].astype(np.int64)
    lens = graph.indptr[nodes + 1].astype(np.int64) - starts
    first = np.cumsum(lens) - lens
    flat = np.arange(int(lens.sum()), dtype=np.int64) \
        - np.repeat(first - starts, lens)
    row = np.repeat(np.arange(len(nodes), dtype=np.int64), lens)
    p = pos[graph.indices[flat]]
    ok = p >= 0
    es, ed = p[ok][:cap_e], row[ok][:cap_e]
    n_pad, e_pad = cap_n - len(nodes), cap_e - len(es)
    train_set = np.zeros(graph.num_nodes, bool)
    train_set[graph.train_ids] = True
    return SubgraphBatch.from_arrays(
        nodes=np.pad(nodes, (0, n_pad), constant_values=graph.num_nodes),
        node_mask=np.pad(np.ones(len(nodes), bool), (0, n_pad)),
        edge_src=np.pad(es, (0, e_pad)),
        edge_dst=np.pad(ed, (0, e_pad)),
        edge_mask=np.pad(np.ones(len(es), bool), (0, e_pad)),
        labels=np.pad(graph.labels[nodes], (0, n_pad)),
        loss_mask=np.pad(train_set[nodes], (0, n_pad)),
        device=device)


class SubgraphTrainer:
    """GraphSAGE parameters, AdamW state and the device feature matrix of
    a subgraph baseline; `step` is one AdamW step on a `SubgraphBatch`,
    `accuracy` one evaluation."""

    def __init__(self, graph: Graph, cfg: GNNConfig, tcfg: TrainConfig,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.seed = cfg, tcfg, seed
        self.params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                               self.device)
        self.opt_state = adamw.init(list(self.params.parameters()))
        self.feats = torch.as_tensor(graph.features,
                                     dtype=torch.float32).to(self.device)

    def _inputs(self, batch: SubgraphBatch) -> torch.Tensor:
        n = self.feats.shape[0]
        return self.feats[torch.clamp(batch.nodes.long(), max=n - 1)]

    def dropout_gens(self, epoch: int,
                     part: int) -> Optional[List[torch.Generator]]:
        """Per-layer dropout generators of (epoch, part)."""
        if self.cfg.dropout <= 0:
            return None
        return [cursor_generator(self.device, self.seed, epoch, part, i,
                                 SALT_DROPOUT)
                for i in range(self.cfg.num_layers - 1)]

    def step(self, batch: SubgraphBatch, epoch: int,
             part: int) -> torch.Tensor:
        """One AdamW step; returns the (device) loss."""
        params = list(self.params.parameters())
        logits = sage_subgraph_apply(
            self.cfg, self.params, batch, self._inputs(batch), train=True,
            dropout_gens=self.dropout_gens(epoch, part))
        loss = gnn_softmax_ce(logits, batch.labels,
                              batch.loss_mask.to(torch.float32))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            new_p, self.opt_state = adamw.update(
                grads, self.opt_state, params, lr=self.tcfg.learning_rate,
                weight_decay=self.tcfg.weight_decay)
            for p, n in zip(params, new_p):
                p.copy_(n)
        return loss.detach()

    @torch.no_grad()
    def accuracy(self, batch: SubgraphBatch,
                 mask: torch.Tensor) -> torch.Tensor:
        logits = sage_subgraph_apply(self.cfg, self.params, batch,
                                     self._inputs(batch))
        return accuracy(logits, batch.labels, mask)


def clustergcn_caps(graph: Graph, parts_per_batch: int):
    """(cap_n, cap_e): the largest `parts_per_batch` communities' nodes x
    1.3 + 64, and cap_n x max(2 x mean degree, 8) edges."""
    sizes = np.bincount(graph.communities)
    cap_n = int(np.sort(sizes)[-parts_per_batch:].sum() * 1.3) + 64
    deg = graph.degrees()
    return cap_n, int(cap_n * max(deg.mean() * 2, 8))


def train_clustergcn(graph: Graph, cfg: GNNConfig, tcfg: TrainConfig,
                     parts_per_batch: int = 2, seed: int = 0,
                     epochs: int = None, device: DeviceLike = None):
    """Returns dict with per-epoch time / val acc (paper Table 4 / Fig 8)."""
    rng = np.random.default_rng((seed, 0))  # salt 0: legacy stream slot
    tr = SubgraphTrainer(graph, cfg, tcfg, seed, device)
    cap_n, cap_e = clustergcn_caps(graph, parts_per_batch)
    times, losses = [], []
    for ep in range(epochs or tcfg.max_epochs):
        t0 = time.perf_counter()
        for j, part in enumerate(clustergcn_batches(graph, parts_per_batch,
                                                    rng)):
            batch = induced_subgraph(graph, part, cap_n, cap_e, tr.device)
            loss = tr.step(batch, ep, j)
        last = float(loss)                 # waits for the epoch's work
        times.append(time.perf_counter() - t0)
        losses.append(last)
    # validation on induced full graph in community chunks
    val_set = np.zeros(graph.num_nodes, bool)
    val_set[graph.val_ids] = True
    accs, ns = [], []
    for part in clustergcn_batches(graph, parts_per_batch, rng):
        nodes = np.asarray(part)[:cap_n]
        vm = np.zeros(cap_n, bool)
        vm[:len(nodes)] = val_set[nodes]
        if vm.sum() == 0:
            continue
        batch = induced_subgraph(graph, part, cap_n, cap_e, tr.device)
        mask = torch.as_tensor(vm, dtype=torch.float32).to(tr.device)
        accs.append(float(tr.accuracy(batch, mask)))
        ns.append(vm.sum())
    val = float(np.average(accs, weights=ns)) if accs else 0.0
    return {"per_epoch_time_s": float(np.mean(times)), "val_acc": val,
            "loss": losses[-1]}


# ---------------------------------------------------------------------------
# full-batch baseline (paper §2)
# ---------------------------------------------------------------------------
def train_fullbatch(graph: Graph, cfg: GNNConfig, tcfg: TrainConfig,
                    seed: int = 0, epochs: int = None,
                    device: DeviceLike = None):
    tr = SubgraphTrainer(graph, cfg, tcfg, seed, device)
    batch = induced_subgraph(graph, np.arange(graph.num_nodes),
                             graph.num_nodes + 1, graph.num_edges + 1,
                             tr.device)
    val_set = np.zeros(graph.num_nodes + 1, bool)
    val_set[graph.val_ids] = True
    val_mask = torch.as_tensor(val_set, dtype=torch.float32).to(tr.device)
    times, accs = [], []
    for ep in range(epochs or tcfg.max_epochs):
        t0 = time.perf_counter()
        float(tr.step(batch, ep, 0))       # waits for the step
        times.append(time.perf_counter() - t0)
        accs.append(float(tr.accuracy(batch, val_mask)))
    return {"per_epoch_time_s": float(np.mean(times)),
            "val_acc_curve": accs, "val_acc": accs[-1]}


# ---------------------------------------------------------------------------
# LABOR-lite: shared-randomness neighbor sampling (structure-agnostic)
# ---------------------------------------------------------------------------
def labor_lite_epoch_footprint(graph: Graph, batches: np.ndarray,
                               fanouts, seed: int = 0):
    """Unique-footprint comparison: neighbors picked by the globally-shared
    per-node hash ranks (LABOR's dependent sampling), no community info.
    Returns mean unique input nodes per batch."""
    rng = np.random.default_rng((seed, 0))  # salt 0: legacy stream slot
    rank = rng.random(graph.num_nodes)        # shared randomness
    sizes = []
    for b in batches:
        level = np.unique(b[b >= 0])
        for r in fanouts:
            nxt = [level]
            for u in level:
                nbr = graph.indices[graph.indptr[u]:graph.indptr[u + 1]]
                if len(nbr) == 0:
                    continue
                if len(nbr) > r:
                    nbr = nbr[np.argpartition(rank[nbr], r)[:r]]
                nxt.append(nbr)
            level = np.unique(np.concatenate(nxt))
        sizes.append(len(level))
    return float(np.mean(sizes))
