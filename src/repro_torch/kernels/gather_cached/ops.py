"""Public two-level cached gather with its gradient and the device hit
counters (`repro/kernels/gather_cached/ops.py`).

`gather_cached(cache, feats, pos, ids)` serves feature row `ids[k]` from
the cache array when `pos[ids[k]] >= 0` and from the global matrix
otherwise, and returns `(rows, hits, misses)`. The counters are device
scalars (`cache_stats`, the one counting rule, mirrored by
`repro_torch.featcache.cache_stats_np`), so a caller can keep them unread
until a boundary where it reads the host anyway. The forward is the CUDA
kernel on CUDA tensors (`kernel.py`); the backward needs no kernel of its
own: d_cache and d_feats are two fanout-1 masked scatter-adds through the
`gather_agg` backward-dx kernel, and run only for an input that needs a
gradient.
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
