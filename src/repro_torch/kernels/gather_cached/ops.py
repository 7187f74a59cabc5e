"""Public two-level cached gather with its gradient and the device hit
counters (`repro/kernels/gather_cached/ops.py`).

`gather_cached(cache, feats, pos, ids)` serves feature row `ids[k]` from
the cache array when `pos[ids[k]] >= 0` and from the global matrix
otherwise, and returns `(rows, hits, misses)`. The counters are device
scalars (`cache_stats`, the one counting rule, mirrored by
`repro_torch.featcache.cache_stats_np`), so a caller can keep them unread
until a boundary where it reads the host anyway; `cache_ref_updates`
extends them to per-slot hits and per-node misses for the dynamic cache.
The forward is the CUDA kernel on CUDA tensors (`kernel.py`); the
backward needs no kernel of its own: d_cache and d_feats are two
fanout-1 masked scatter-adds through the `gather_agg` backward-dx
kernel, and run only for an input that needs a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_agg.kernel import gather_agg_bwd_dx
from repro_torch.kernels.gather_cached.kernel import gather_cached_fwd


def _hit_mask(pos, ids, num_nodes: int):
    gid = torch.clamp(ids, 0, num_nodes - 1)
    sel = pos[gid.long()]
    hit = (sel >= 0) & (ids >= 0) & (ids < num_nodes)
    return gid, sel, hit


def cache_stats(pos: torch.Tensor, ids: torch.Tensor, num_nodes: int):
    """Device (hits, misses) int32 scalars over the VALID entries of `ids`
    (entries outside [0, num_nodes) are padding and count as neither)."""
    ids = ids.to(torch.int32)
    _, _, hit = _hit_mask(pos, ids, num_nodes)
    valid = (ids >= 0) & (ids < num_nodes)
    hits = hit.sum(dtype=torch.int32)
    return hits, valid.sum(dtype=torch.int32) - hits


def cache_ref_updates(pos: torch.Tensor, ids: torch.Tensor,
                      capacity: int):
    """Per-SLOT hit counts and per-NODE miss counts for one batch of reads
    (`repro/kernels/gather_cached/ops.py:56-77`) — the extended device
    counters behind the dynamic CLOCK admission
    (`repro_torch.featcache.dynamic`).

    Returns `(slot_hits (C,) int32, node_miss (N,) int32)` over the VALID
    entries of `ids` (the validity rule of `cache_stats`; their sums equal
    its hits and misses). Invalid entries and the other side's entries
    add zero at index 0. Integer `index_add_` sums exactly in any order,
    so the result is deterministic on the card too; nothing is read on
    the host. Mirror: `repro_torch.featcache.cache_ref_updates_np`."""
    num_nodes = pos.shape[0]
    ids = ids.to(torch.int32)
    gid, sel, hit = _hit_mask(pos, ids, num_nodes)
    valid = (ids >= 0) & (ids < num_nodes)
    miss = valid & ~hit
    slot_hits = torch.zeros(capacity, dtype=torch.int32, device=pos.device)
    slot_hits.index_add_(0, torch.where(hit, sel, 0).long(),
                         hit.to(torch.int32))
    node_miss = torch.zeros(num_nodes, dtype=torch.int32, device=pos.device)
    node_miss.index_add_(0, torch.where(miss, gid, 0).long(),
                         miss.to(torch.int32))
    return slot_hits, node_miss


class _GatherCached(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cache, feats, pos, ids):
        ctx.save_for_backward(pos, ids)
        ctx.sizes = (cache.shape[0], feats.shape[0])
        return gather_cached_fwd(cache, feats, pos, ids)

    @staticmethod
    def backward(ctx, g):
        pos, ids = ctx.saved_tensors
        C, N = ctx.sizes
        M = ids.shape[0]
        g = g.contiguous()
        gid, sel, hit = _hit_mask(pos, ids, N)
        d_cache = d_feats = None
        if ctx.needs_input_grad[0]:
            d_cache = gather_agg_bwd_dx(
                torch.clamp(sel, min=0).reshape(M, 1).contiguous(),
                hit.to(torch.float32).reshape(M, 1), g, C)
        if ctx.needs_input_grad[1]:
            d_feats = gather_agg_bwd_dx(
                gid.reshape(M, 1).contiguous(),
                (~hit).to(torch.float32).reshape(M, 1), g, N)
        return d_cache, d_feats, None, None


def gather_cached(cache: torch.Tensor, feats: torch.Tensor,
                  pos: torch.Tensor, ids: torch.Tensor):
    """Two-level gather: `(rows (M, F) float32, hits, misses)`.

    cache: (C, F) admitted rows (exact copies, so a hit is bit-identical
    to a global read); feats: (N, F) float32; pos: (N,) int32 (-1 = miss);
    ids: (M,) int global row ids — entries outside [0, N) are padding,
    served from the clipped global row (mask downstream) and excluded
    from the counters. Differentiable in cache and feats."""
    ids = ids.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    hits, misses = cache_stats(pos, ids, feats.shape[0])
    rows = _GatherCached.apply(cache.contiguous(), feats.contiguous(), pos,
                               ids)
    return rows, hits, misses
