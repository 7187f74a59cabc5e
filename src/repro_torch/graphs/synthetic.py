"""Synthetic community-structured graphs (offline stand-ins for
reddit / ogbn-products / igb). A copy of `repro/graphs/synthetic.py`: the
same spec and seed give the same arrays in both packages.

Generator: degree-corrected stochastic block model with power-law-ish
community sizes, label-correlated features, and the paper's train/val/test
split ratios. Nodes are emitted in RANDOM order (like the raw datasets);
community-based reordering is an explicit preprocessing step, as in the
paper.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graphs.csr import Graph, symmetrize


@dataclass(frozen=True)
class SBMSpec:
    name: str
    num_nodes: int = 20_000
    num_communities: int = 40
    avg_degree: float = 20.0
    p_intra: float = 0.9          # fraction of edge endpoints intra-community
    feat_dim: int = 64
    num_classes: int = 16
    label_noise: float = 0.1
    feat_noise: float = 1.0
    train_frac: float = 0.66      # reddit-like by default
    val_frac: float = 0.10
    community_size_skew: float = 1.3   # >1: power-lawish sizes
    seed: int = 0


# dataset registry: scaled-down mirrors of the paper's four graphs
REDDIT_LIKE = SBMSpec("reddit-like", 20_000, 40, 40.0, 0.9, 64, 16,
                      train_frac=0.66, val_frac=0.10, seed=1)
PRODUCTS_LIKE = SBMSpec("products-like", 50_000, 120, 25.0, 0.92, 50, 32,
                        train_frac=0.08, val_frac=0.02, seed=2)
IGB_LIKE = SBMSpec("igb-like", 30_000, 64, 13.0, 0.88, 96, 19,
                   train_frac=0.60, val_frac=0.20, seed=3)
PAPERS_LIKE = SBMSpec("papers-like", 80_000, 200, 18.0, 0.94, 32, 24,
                      train_frac=0.011, val_frac=0.001, seed=4)
TINY = SBMSpec("tiny", 2_000, 8, 12.0, 0.9, 16, 4, seed=5)

DATASETS = {s.name: s for s in
            (REDDIT_LIKE, PRODUCTS_LIKE, IGB_LIKE, PAPERS_LIKE, TINY)}


def _community_sizes(rng, spec) -> np.ndarray:
    w = rng.pareto(spec.community_size_skew, spec.num_communities) + 1.0
    sizes = np.maximum((w / w.sum() * spec.num_nodes).astype(np.int64), 8)
    # fix rounding so sizes sum to N
    diff = spec.num_nodes - sizes.sum()
    sizes[np.argmax(sizes)] += diff
    return sizes


def generate(spec: SBMSpec) -> Graph:
    # salt 0 = legacy stream slot: trailing-zero SeedSequence tuples
    # spawn the SAME stream as the bare int, so every pinned DATASETS
    # graph is bit-identical to pre-conversion builds
    rng = np.random.default_rng((spec.seed, 0))
    N, C = spec.num_nodes, spec.num_communities
    sizes = _community_sizes(rng, spec)
    comm_of = np.repeat(np.arange(C, dtype=np.int32), sizes)
    # emit nodes in random order (raw datasets are not community-sorted)
    shuffle = rng.permutation(N)
    comm_of = comm_of[shuffle]

    # --- edges: degree-corrected SBM ---
    E_target = int(N * spec.avg_degree / 2)
    # node propensity (power-law degrees)
    theta = rng.pareto(2.0, N) + 1.0
    members = [np.where(comm_of == c)[0] for c in range(C)]
    mem_theta = [theta[m] / theta[m].sum() for m in members]

    n_intra_e = int(E_target * spec.p_intra)
    n_inter_e = E_target - n_intra_e
    # intra edges: pick community ~ size, endpoints ~ theta within it
    comm_w = np.array([t.sum() for t in
                       (theta[m] for m in members)])
    comm_w = comm_w / comm_w.sum()
    cs = rng.choice(C, n_intra_e, p=comm_w)
    src = np.empty(E_target, np.int64)
    dst = np.empty(E_target, np.int64)
    counts = np.bincount(cs, minlength=C)
    o = 0
    for c in range(C):
        k = counts[c]
        if k == 0:
            continue
        m, w = members[c], mem_theta[c]
        src[o:o + k] = rng.choice(m, k, p=w)
        dst[o:o + k] = rng.choice(m, k, p=w)
        o += k
    # inter edges: uniform-ish theta-weighted across graph
    pw = theta / theta.sum()
    src[o:] = rng.choice(N, n_inter_e, p=pw)
    dst[o:] = rng.choice(N, n_inter_e, p=pw)

    keep = src != dst
    src, dst = src[keep], dst[keep]
    indptr = np.zeros(N + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    order = np.argsort(src, kind="stable")
    indices = dst[order].astype(np.int32)
    indptr, indices = symmetrize(indptr, indices)

    # --- labels: communities map to classes (several communities share a
    # class), plus noise so the task is non-trivial ---
    class_of_comm = rng.integers(0, spec.num_classes, C)
    labels = class_of_comm[comm_of].astype(np.int32)
    flip = rng.random(N) < spec.label_noise
    labels[flip] = rng.integers(0, spec.num_classes, flip.sum())

    # --- features: class centroid + community offset + noise ---
    class_mu = rng.normal(0, 1, (spec.num_classes, spec.feat_dim))
    comm_mu = rng.normal(0, 0.5, (C, spec.feat_dim))
    feats = (class_mu[labels] + comm_mu[comm_of]
             + rng.normal(0, spec.feat_noise, (N, spec.feat_dim)))
    feats = feats.astype(np.float32)

    # --- splits ---
    perm = rng.permutation(N)
    n_tr = int(N * spec.train_frac)
    n_va = int(N * spec.val_frac)
    g = Graph(
        indptr=indptr, indices=indices, features=feats, labels=labels,
        train_ids=np.sort(perm[:n_tr]),
        val_ids=np.sort(perm[n_tr:n_tr + n_va]),
        test_ids=np.sort(perm[n_tr + n_va:]),
        communities=comm_of,       # ground-truth ("oracle") communities
        name=spec.name,
    )
    return g


def load(name: str) -> Graph:
    return generate(DATASETS[name])
