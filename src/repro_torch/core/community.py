"""Community detection: Louvain-style modularity maximization (2 levels).
A copy of `repro/core/community.py` (pure numpy).

The paper uses RABBIT (parallel hierarchical modularity clustering); COMM-RAND
only needs *a* community assignment (§4, footnote 3), so a single-process
Louvain is sufficient here. Synthetic datasets also carry ground-truth
("oracle") communities to decouple detector quality from policy behavior.
"""
from __future__ import annotations

import numpy as np


def _local_moving(indptr, indices, comm, max_sweeps=5, rng=None):
    """One Louvain level: greedy modularity local moving. Returns (comm,
    improved)."""
    N = len(indptr) - 1
    deg = np.diff(indptr).astype(np.float64)
    two_m = deg.sum()
    if two_m == 0:
        return comm, False
    sigma_tot = np.zeros(comm.max() + 1 if len(comm) else 1, np.float64)
    np.add.at(sigma_tot, comm, deg)
    improved_any = False
    order = np.arange(N)
    # salt 0 is the reserved legacy slot: a trailing-zero SeedSequence
    # tuple spawns the SAME stream as the old bare-int seed, so pinned
    # partitions stay bit-stable (new call sites take nonzero salts)
    rng = rng or np.random.default_rng((0, 0))
    for _ in range(max_sweeps):
        rng.shuffle(order)
        moved = 0
        for u in order:
            s, e = indptr[u], indptr[u + 1]
            if s == e:
                continue
            nbrs = indices[s:e]
            nbrs = nbrs[nbrs != u]       # self-loops move with u; exclude
            if len(nbrs) == 0:
                continue
            cu = comm[u]
            # edge weight from u to each neighboring community
            ncomms, k_in = np.unique(comm[nbrs], return_counts=True)
            sigma_tot[cu] -= deg[u]
            # modularity gain of moving u into c: k_in(c) - deg_u*S_tot(c)/2m
            gain = k_in - deg[u] * sigma_tot[ncomms] / two_m
            best = ncomms[np.argmax(gain)]
            in_cu = ncomms == cu
            k_in_cu = float(k_in[in_cu][0]) if in_cu.any() else 0.0
            cur_gain = k_in_cu - deg[u] * sigma_tot[cu] / two_m
            if gain.max() > cur_gain + 1e-12 and best != cu:
                comm[u] = best
                moved += 1
            sigma_tot[comm[u]] += deg[u]
        improved_any |= moved > 0
        if moved == 0:
            break
    return comm, improved_any


def _compress(comm):
    uniq, inv = np.unique(comm, return_inverse=True)
    return inv.astype(np.int32), len(uniq)


def _aggregate(indptr, indices, comm, n_comm):
    """Community meta-graph with multiplicity preserved, INCLUDING
    intra-community self-loops (required for correct degrees/modularity at
    the next level)."""
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    cs, cd = comm[src], comm[indices]
    order = np.argsort(cs, kind="stable")
    cs, cd = cs[order], cd[order]
    new_indptr = np.zeros(n_comm + 1, np.int64)
    np.add.at(new_indptr, cs + 1, 1)
    np.cumsum(new_indptr, out=new_indptr)
    return new_indptr, cd.astype(np.int32)


def louvain(indptr, indices, levels: int = 2, seed: int = 0) -> np.ndarray:
    """Returns community id per node (int32, compacted)."""
    rng = np.random.default_rng((seed, 0))  # salt 0: legacy stream slot
    N = len(indptr) - 1
    comm = np.arange(N, dtype=np.int32)
    comm, _ = _local_moving(indptr, indices, comm, rng=rng)
    comm, n1 = _compress(comm)
    for _ in range(levels - 1):
        aggr_ptr, aggr_idx = _aggregate(indptr, indices, comm, n1)
        meta = np.arange(n1, dtype=np.int32)
        meta, improved = _local_moving(aggr_ptr, aggr_idx, meta, rng=rng)
        meta, n2 = _compress(meta)
        if not improved or n2 == n1:
            break
        comm = meta[comm]
        n1 = n2
    return comm


def modularity(indptr, indices, comm) -> float:
    deg = np.diff(indptr).astype(np.float64)
    two_m = deg.sum()
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    intra = (comm[src] == comm[indices]).sum() / two_m
    sigma = np.zeros(comm.max() + 1, np.float64)
    np.add.at(sigma, comm, deg)
    expected = np.sum((sigma / two_m) ** 2)
    return float(intra - expected)
