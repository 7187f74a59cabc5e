"""The biased two-phase neighbor sampler (`repro/sampling/device.py:45-111`)
on torch tensors, plus its numpy mirror (copied).

Static-shape contract: (M,) nodes in (sentinel `num_nodes` for padding),
(M, fanout) int32 sources + bool mask out, self-loop for isolated nodes,
sentinel-propagating for padded rows.

Every float step is float32, as in the reference: `p_intra` with its
`1e-9` guard, `floor(u * n)` with the int32 count promoted to float32, and
the clip to `deg - 1` — so the same uniforms pick the same offsets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.sampling.base import register_sampler


def _row_meta(g, nodes):
    """Shared per-row lookups; `safe` clamps padded rows to node 0."""
    valid = nodes < g.num_nodes
    safe = torch.where(valid, nodes, 0)
    return valid, safe, g.indptr[safe], g.degrees[safe]


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
        # an isolated node at the end of the CSR starts at E: clamp, as
        # JAX's gather does (`_finish` replaces its draws with itself)
        src = g.indices[torch.clamp(start[:, None] + offset,
                                    max=g.indices.shape[0] - 1)]
        return _finish(g, valid, safe, deg, src)

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
