"""The four registered neighbor samplers (`repro/sampling/device.py`) on
torch tensors, plus their numpy mirrors (copied).

Static-shape contract: (M,) nodes in (sentinel `num_nodes` for padding),
(M, fanout) int32 sources + bool mask out, self-loop for isolated nodes,
sentinel-propagating for padded rows.

Every float step is float32, as in the reference: `p_intra` with its
`1e-9` guard, `floor(u * n)` with the int32 count promoted to float32, and
the clip to `deg - 1` — so the same uniforms pick the same offsets.

`LaborSampler` is LABOR-lite [9]: every node gets a rank from a hash of
its id with two uint32 epoch words (`_hash_rank01`, the reference's mix in
int64 masked to 32 bits, then int64 -> float32 rounding, which equals
numpy's uint32 -> float32), and each destination keeps its `fanout`
lowest-ranked neighbors. Equal ranks (ids that collide after the float32
rounding, duplicate edges) keep the lower slot first, as
`jax.lax.top_k(-rank)` does (`_k_lowest`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List

import numpy as np
import torch

from repro_torch.core.hash32 import hash_u32
from repro_torch.sampling.base import register_sampler


def _row_meta(g, nodes):
    """Shared per-row lookups; `safe` clamps padded rows to node 0."""
    valid = nodes < g.num_nodes
    safe = torch.where(valid, nodes, 0)
    return valid, safe, g.indptr[safe], g.degrees[safe]


def _cand(g, start, offset):
    """`g.indices[start + offset]`, clamped into the CSR: an isolated node
    at the end of the CSR starts at E, where JAX's gather clamps (the
    caller replaces such a row's picks)."""
    return g.indices[torch.clamp(start[:, None] + offset,
                                 max=max(g.indices.shape[0] - 1, 0))]


def _finish(g, valid, safe, deg, src):
    """Isolated nodes aggregate themselves; padded rows propagate the
    sentinel."""
    src = torch.where(deg[:, None] > 0, src, safe[:, None])
    src = torch.where(valid[:, None], src, g.num_nodes)
    mask = (valid & (deg > 0))[:, None].expand(src.shape)
    return src.to(torch.int32), mask


@register_sampler("biased")
@dataclass(frozen=True)
class BiasedTwoPhaseSampler:
    """Paper §4.2 (Figure 4): intra-community edges drawn with unnormalized
    weight `p`, inter with `1-p`. Thanks to the intra-first CSR row layout
    (`n_intra[u]` split point) a draw is two-phase — pick the class with
    prob p*n_intra / (p*n_intra + (1-p)*n_inter), then uniform within the
    class — O(1) per sample, no |E|-sized weight array. With replacement
    within the class. p=0.5 is uniform over neighbors."""

    p: float = 0.5
    shared_randomness: ClassVar[bool] = False

    @property
    def name(self) -> str:
        return "biased"

    def draw(self, gen: torch.Generator, M: int, fanout: int):
        """(u_class, u_off), each (M, fanout) float32 in [0, 1), from
        `gen` on its own device."""
        u_class = torch.rand((M, fanout), generator=gen, device=gen.device)
        u_off = torch.rand((M, fanout), generator=gen, device=gen.device)
        return u_class, u_off

    def sample(self, g, nodes, fanout: int, u_class, u_off):
        valid, safe, start, deg = _row_meta(g, nodes)
        ni = g.n_intra[safe]
        no = deg - ni

        w_i = self.p * ni.to(torch.float32)
        w_o = (1.0 - self.p) * no.to(torch.float32)
        tot = w_i + w_o
        p_intra = torch.where(tot > 0, w_i / torch.clamp(tot, min=1e-9), 0.0)
        p_intra = torch.where(no == 0, 1.0,
                              torch.where(ni == 0, 0.0, p_intra))

        intra = u_class < p_intra[:, None]
        off_i = torch.floor(u_off * ni[:, None]).to(torch.int32)
        off_o = ni[:, None] + torch.floor(u_off * no[:, None]).to(torch.int32)
        offset = torch.where(intra, off_i, off_o)
        offset = torch.minimum(torch.clamp(offset, min=0),
                               torch.clamp(deg - 1, min=0)[:, None])
        return _finish(g, valid, safe, deg, _cand(g, start, offset))

    def sample_level_np(self, rng, graph, level, fanout: int,
                        ctx: dict) -> List:
        comm = graph.communities
        srcs = []
        for u in level:
            s, e = graph.indptr[u], graph.indptr[u + 1]
            nbrs = graph.indices[s:e]
            if len(nbrs) == 0:
                srcs.append(np.array([u] * fanout))
                continue
            intra = comm[nbrs] == comm[u]
            ni, no = int(intra.sum()), int((~intra).sum())
            w_i, w_o = self.p * ni, (1 - self.p) * no
            pi = 1.0 if no == 0 else (0.0 if ni == 0 else w_i / (w_i + w_o))
            cls = rng.random(fanout) < pi
            nbr_i = nbrs[intra] if ni else nbrs
            nbr_o = nbrs[~intra] if no else nbrs
            pick = np.where(cls,
                            nbr_i[rng.integers(0, max(ni, 1), fanout)],
                            nbr_o[rng.integers(0, max(no, 1), fanout)])
            srcs.append(pick)
        return srcs

    def describe(self) -> str:
        return f"biased-two-phase(p={self.p:g})"


@register_sampler("uniform")
@dataclass(frozen=True)
class UniformSampler:
    """Uniform with-replacement draw over the whole adjacency row — the
    classic GraphSAGE sampler, with no community bias and a single uniform
    per slot (distributionally equal to `biased` at p=0.5)."""

    shared_randomness: ClassVar[bool] = False

    @property
    def name(self) -> str:
        return "uniform"

    def draw(self, gen: torch.Generator, M: int, fanout: int):
        """(u,), (M, fanout) float32 in [0, 1), from `gen`."""
        return (torch.rand((M, fanout), generator=gen, device=gen.device),)

    def sample(self, g, nodes, fanout: int, u):
        valid, safe, start, deg = _row_meta(g, nodes)
        offset = torch.floor(u * deg[:, None]).to(torch.int32)
        offset = torch.minimum(torch.clamp(offset, min=0),
                               torch.clamp(deg - 1, min=0)[:, None])
        return _finish(g, valid, safe, deg, _cand(g, start, offset))

    def sample_level_np(self, rng, graph, level, fanout: int,
                        ctx: dict) -> List:
        srcs = []
        for u in level:
            nbrs = graph.indices[graph.indptr[u]:graph.indptr[u + 1]]
            if len(nbrs) == 0:
                srcs.append(np.array([u] * fanout))
                continue
            srcs.append(nbrs[rng.integers(0, len(nbrs), fanout)])
        return srcs

    def describe(self) -> str:
        return "uniform"


@register_sampler("full")
@dataclass(frozen=True)
class FullNeighborhoodSampler:
    """Deterministic enumeration of the first `fanout` neighbors (fanout >=
    max degree gives exact full-neighborhood aggregation). Draws
    nothing."""

    shared_randomness: ClassVar[bool] = False

    @property
    def name(self) -> str:
        return "full"

    def draw(self, gen: torch.Generator, M: int, fanout: int):
        return ()

    def sample(self, g, nodes, fanout: int):
        N = g.num_nodes
        valid, safe, start, deg = _row_meta(g, nodes)
        j = torch.arange(fanout, dtype=torch.int32, device=nodes.device)
        mask = (j[None, :] < deg[:, None]) & valid[:, None]
        offset = torch.minimum(j[None, :],
                               torch.clamp(deg - 1, min=0)[:, None])
        src = torch.where(mask, _cand(g, start, offset),
                          torch.where(valid, safe, N)[:, None])
        return src.to(torch.int32), mask

    def sample_level_np(self, rng, graph, level, fanout: int,
                        ctx: dict) -> List:
        return [graph.indices[graph.indptr[u]:graph.indptr[u + 1]][:fanout]
                for u in level]

    def describe(self) -> str:
        return "full-neighborhood"


def _hash_rank01(words, ids: torch.Tensor) -> torch.Tensor:
    """Shared LABOR randomness: the murmur3-finalizer mix of each node id
    with the two epoch words -> float32 in [0, 1). Depends ONLY on (words,
    id): the same node gets the same rank in every row, batch and hop of
    an epoch."""
    x = hash_u32(ids, words, 0)
    return x.to(torch.float32) * (2.0 ** -32)


def _k_lowest(rank: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest entries of each row of `rank`
    (float32, >= 0 or inf), in ascending order, the lower column first
    among equal values: what `jax.lax.top_k(-rank, k)` returns.
    `torch.topk` orders ties otherwise, so it selects on keys made
    distinct: the rank's bits (monotone for non-negative floats) above
    the column index."""
    D = rank.shape[1]
    shift = max(D - 1, 1).bit_length()
    col = torch.arange(D, dtype=torch.int64, device=rank.device)
    keys = (rank.view(torch.int32).to(torch.int64) << shift) | col
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).indices


@register_sampler("labor")
@dataclass(frozen=True)
class LaborSampler:
    """Device-side LABOR-lite [9] (Balın et al.): every candidate neighbor
    t gets rank = hash(epoch words, t); each destination keeps its
    `fanout` LOWEST-ranked neighbors (without replacement). Destinations
    with overlapping neighborhoods pick the shared low-rank candidates, so
    the unique-node footprint collapses under dedup with no community
    information, and the picks repeat across hops and batches within an
    epoch.

    The rank gather materialises an (M, max_degree) tile, so a draw costs
    O(max_degree) rather than the biased sampler's O(1)."""

    shared_randomness: ClassVar[bool] = True

    @property
    def name(self) -> str:
        return "labor"

    def draw(self, gen: torch.Generator, M: int, fanout: int):
        return ()

    def epoch_ctx(self, words, g) -> torch.Tensor:
        """The per-epoch shared state: every node's rank under the two
        epoch `words`, on `g`'s device (computed once per epoch)."""
        ids = torch.arange(g.num_nodes, dtype=torch.int64, device=g.device)
        return _hash_rank01(words, ids)

    def sample(self, g, nodes, fanout: int, ranks=None):
        if ranks is None:
            raise ValueError("the LABOR sampler needs the epoch's ranks "
                             "(ranks=sampler.epoch_ctx(words, g))")
        if g.max_degree == 0 and g.indices.shape[0] > 0:
            raise ValueError(
                "DeviceGraph.max_degree is unset; rebuild the device graph "
                "with DeviceGraph.from_graph for the LABOR sampler")
        N = g.num_nodes
        D = max(int(g.max_degree), fanout, 1)
        valid, safe, start, deg = _row_meta(g, nodes)
        j = torch.arange(D, dtype=torch.int32, device=nodes.device)
        in_row = j[None, :] < deg[:, None]
        offset = torch.minimum(j[None, :],
                               torch.clamp(deg - 1, min=0)[:, None])
        cand = _cand(g, start, offset)                       # (M, D)
        rank = torch.where(in_row, ranks[cand.long()], float("inf"))
        src = torch.gather(cand, 1, _k_lowest(rank, fanout))
        keep = torch.arange(fanout, device=nodes.device)[None, :] < \
            torch.clamp(deg, max=fanout)[:, None]
        mask = keep & valid[:, None]
        src = torch.where(mask, src, torch.where(valid, safe, N)[:, None])
        return src.to(torch.int32), mask

    @staticmethod
    def epoch_ranks_np(words, num_nodes: int) -> np.ndarray:
        """Numpy mirror of `epoch_ctx`: identical uint32 mixing of
        arange(num_nodes) with the two epoch words, identical
        uint32 -> float32 rounding — bit for bit the device ranks."""
        x = np.arange(num_nodes, dtype=np.uint32)
        for w in np.asarray(words).ravel().astype(np.uint32):
            x = x ^ np.uint32(w)
            x = x * np.uint32(0x85EBCA6B)
            x = x ^ (x >> np.uint32(13))
            x = x * np.uint32(0xC2B2AE35)
            x = x ^ (x >> np.uint32(16))
        return x.astype(np.float32) * np.float32(2.0 ** -32)

    def sample_level_np(self, rng, graph, level, fanout: int,
                        ctx: dict) -> List:
        rank = ctx.get("labor_rank")
        if rank is None:                    # one shared draw per epoch
            ew = ctx.get("epoch_words")
            rank = ctx["labor_rank"] = (
                self.epoch_ranks_np(ew, graph.num_nodes)
                if ew is not None else rng.random(graph.num_nodes))
        srcs = []
        for u in level:
            nbrs = graph.indices[graph.indptr[u]:graph.indptr[u + 1]]
            if len(nbrs) == 0:
                continue
            if len(nbrs) > fanout:
                nbrs = nbrs[np.argpartition(rank[nbrs], fanout)[:fanout]]
            srcs.append(nbrs)
        return srcs

    def describe(self) -> str:
        return "labor(shared-hash-topk)"
