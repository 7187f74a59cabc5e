"""Static-shape mini-batch construction (`repro/core/minibatch.py`) on
torch tensors.

A batch is a tower of node levels F_0 (roots) ⊂ F_1 ⊂ ... ⊂ F_L (input
level), built by neighbor sampling (`repro_torch.sampling`) + *static-size
dedup* into per-level caps calibrated per (policy, sampler)
(`calibrate_caps`, copied numpy). Samplers with `shared_randomness`
(LABOR) take the epoch's `ranks` — the same at every hop and batch of an
epoch — instead of per-(batch, hop) uniforms. Blocks are stored
input-side first: blocks[0] maps F_L -> F_{L-1}. Every dst has exactly
`fanout` sampled source slots + one self slot, so aggregation is a
masked mean over a dense (n_dst, fanout) gather — no segment ops.

The build issues no host synchronisation: `_unique_capped` reproduces
`jnp.unique(size=cap, fill_value=N)` (sorted, padded, truncating) with a
sort, a first-of-run mask, a cumulative sum and a scatter, where
`torch.unique` would have a data-dependent size.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import sampling
from repro_torch.core import partition
from repro_torch.graphs.csr import DeviceGraph, Graph


@dataclass
class Block:
    src_pos: torch.Tensor     # (n_dst, fanout) int32 positions into src level
    self_pos: torch.Tensor    # (n_dst,) int32 position of dst in src level
    edge_mask: torch.Tensor   # (n_dst, fanout) bool
    dst_mask: torch.Tensor    # (n_dst,) bool

    def to(self, device) -> "Block":
        return Block(*(getattr(self, f.name).to(device) for f in fields(self)))


@dataclass
class MiniBatch:
    levels: List[torch.Tensor]  # per-level sorted unique node ids, 0=roots
    node_mask: torch.Tensor   # (cap_L,) bool — input level validity
    blocks: List[Block]       # input-side first
    labels: torch.Tensor      # (B,) int32 (aligned with levels[0])
    label_mask: torch.Tensor  # (B,) bool

    @property
    def node_ids(self):
        """Input-level unique node ids (feature-gather index)."""
        return self.levels[-1]

    @property
    def roots(self):
        return self.levels[0]

    @property
    def num_unique(self):
        return self.node_mask.sum()

    def to(self, device) -> "MiniBatch":
        return MiniBatch(
            levels=[lv.to(device) for lv in self.levels],
            node_mask=self.node_mask.to(device),
            blocks=[b.to(device) for b in self.blocks],
            labels=self.labels.to(device),
            label_mask=self.label_mask.to(device))


def _positions(level: torch.Tensor, ids: torch.Tensor):
    """Map node ids -> positions in the sorted unique `level` array
    (left-sided search, clamped to the last slot)."""
    pos = torch.searchsorted(level, ids, out_int32=True)
    pos = torch.clamp(pos, max=level.shape[0] - 1)
    ok = level[pos] == ids
    return pos, ok


def _unique_capped(ids: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """`jnp.unique(ids, size=cap, fill_value=fill)`: the sorted distinct
    values, padded with `fill` and truncated past `cap`, without a host
    sync. Only the first element of each run writes; runs past `cap` write
    into a spill slot that is cut off."""
    s = torch.sort(ids).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first, 0) - 1
    slot = torch.where(first & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), fill, dtype=ids.dtype, device=ids.device)
    out.scatter_(0, slot, s)
    return out[:cap]


Draw = Callable[[int, int, int], Tuple[torch.Tensor, ...]]


def sampler_epoch_ctx(sampler, words, g: DeviceGraph):
    """Per-epoch device state a shared-randomness sampler precomputes once
    (LABOR's node ranks from the two epoch `words`); None for samplers
    without one."""
    fn = getattr(sampler, "epoch_ctx", None)
    if not (sampler.shared_randomness and callable(fn)):
        return None
    if words is None:
        raise ValueError(f"sampler {sampler.describe()} shares randomness "
                         f"across an epoch: pass the epoch's words")
    return fn(words, g)


def _build_batch_impl(g: DeviceGraph, roots: torch.Tensor,
                      labels_all: torch.Tensor, fanouts: Tuple[int, ...],
                      caps: Tuple[int, ...], sampler, draw: Draw,
                      ranks: Optional[torch.Tensor] = None) -> MiniBatch:
    """The build body. `draw(hop, M, fanout)` supplies the sampler's
    uniforms for the M rows of that hop (a tuple, empty for full and
    LABOR): per-cursor generators in the stream, the reference's own
    uniforms in the parity tests. `ranks`: a shared-randomness sampler's
    epoch state (`sampler_epoch_ctx`), handed to every hop."""
    N = g.num_nodes
    B = roots.shape[0]
    root_mask = roots >= 0
    level = torch.where(root_mask, roots, N).to(torch.int32)
    # roots must be sorted for searchsorted-based mapping; keep label order
    level = torch.sort(level).values
    labels = torch.where(root_mask,
                         labels_all[torch.where(root_mask, roots, 0)], 0)

    levels = [level]
    blocks = []
    for h, (r, cap) in enumerate(zip(fanouts, caps)):
        prev = levels[-1]
        u = draw(h, prev.shape[0], r)
        if ranks is not None:
            srcs, smask = sampler.sample(g, prev, r, *u, ranks=ranks)
        else:
            srcs, smask = sampler.sample(g, prev, r, *u)
        all_ids = torch.cat([prev, srcs.reshape(-1)])
        nxt = _unique_capped(all_ids, cap, N)
        self_pos, self_ok = _positions(nxt, prev)
        src_pos, src_ok = _positions(nxt, srcs.reshape(-1))
        blocks.append(Block(
            src_pos=src_pos.reshape(prev.shape[0], r),
            self_pos=self_pos,
            edge_mask=(smask & src_ok.reshape(prev.shape[0], r)
                       & (srcs < N)),
            dst_mask=(prev < N) & self_ok,
        ))
        levels.append(nxt)

    top = levels[-1]
    # labels aligned to the SORTED root level: re-gather via positions.
    # Every padding root maps to one position and writes 0 / False there.
    root_pos, _ = _positions(levels[0],
                             torch.where(root_mask, roots, N).to(torch.int32))
    root_pos = root_pos.long()
    lab_sorted = torch.zeros((B,), dtype=labels_all.dtype,
                             device=roots.device).scatter_(
        0, root_pos, labels.to(labels_all.dtype))
    lmask = torch.zeros((B,), dtype=torch.bool,
                        device=roots.device).scatter_(0, root_pos, root_mask)
    return MiniBatch(
        levels=levels,
        node_mask=top < N,
        blocks=blocks[::-1],
        labels=lab_sorted,
        label_mask=lmask & (levels[0] < N),
    )


def build_batch(g: DeviceGraph, roots, labels_all, fanouts, caps,
                sampler=0.5, *, draw: Draw, epoch_words=None) -> MiniBatch:
    """roots: (B,) int32 with -1 padding, on `g`'s device. caps: per-level
    unique caps, len == len(fanouts), cap for levels 1..L (level 0 cap is
    B). `sampler` is a `repro_torch.sampling` sampler (a bare float selects
    the biased two-phase draw at that `p`). `epoch_words` (two uint32)
    feed shared-randomness samplers (LABOR), which need them."""
    s = sampling.resolve(sampler)
    return _build_batch_impl(g, roots, labels_all, tuple(fanouts),
                             tuple(caps), s, draw,
                             sampler_epoch_ctx(s, epoch_words, g))


# ---------------------------------------------------------------------------
# numpy reference builder (exact dedup; calibration oracle) — copied
# ---------------------------------------------------------------------------
def build_batch_np(rng: np.random.Generator, graph: Graph, roots, fanouts,
                   sampler=0.5, ctx: dict = None):
    """Returns per-level unique-node counts + the input-level footprint.
    `ctx` carries per-epoch shared sampler state (LABOR's ranks, or the
    `epoch_words` they hash) across batches of one epoch."""
    s = sampling.resolve(sampler)
    ctx = {} if ctx is None else ctx
    level = np.unique(roots[roots >= 0])
    sizes = [len(level)]
    for r in fanouts:
        srcs = s.sample_level_np(rng, graph, level, r, ctx)
        level = np.unique(np.concatenate([level] + list(srcs)))
        sizes.append(len(level))
    return sizes, level


def calibrate_caps(graph: Graph, policy, batch_size: int,
                   fanouts, n_probe: int = 6, margin: float = 1.15,
                   seed: int = 0, align: int = 128) -> Tuple[int, ...]:
    """Policy-derived static caps: max unique nodes per level over probe
    batches x margin, rounded up to `align`. The probe samples through the
    policy's bound sampler, so LABOR's collapsed footprint yields smaller
    caps. Probe batch indices are drawn uniformly across
    the epoch: under comm_rand the LEADING batches of an epoch order are
    community-pure and under-estimate the footprint of the late, mixed
    batches."""
    rng = np.random.default_rng((seed, 0))
    s = sampling.for_policy(policy)
    maxes = np.zeros(len(fanouts), np.int64)
    probes = 0
    while probes < n_probe:
        ctx = {}                        # fresh shared state per probe epoch
        batches = partition.batches_for_epoch(
            graph.train_ids, graph.communities, policy, batch_size, rng)
        take = min(max(1, n_probe - probes), len(batches))
        idx = np.sort(rng.choice(len(batches), size=take, replace=False))
        for b in batches[idx]:
            sizes, _ = build_batch_np(rng, graph, b, fanouts, s, ctx=ctx)
            maxes = np.maximum(maxes, sizes[1:])
            probes += 1
            if probes >= n_probe:
                break
    caps = []
    lo = batch_size
    for m in maxes:
        c = int(np.ceil(m * margin / align) * align)
        c = max(c, lo + align)       # level must fit its predecessor
        caps.append(c)
        lo = c
    return tuple(caps)


def feature_bytes(batch_or_cap, feat_dim: int, itemsize: int = 4) -> int:
    """Paper Fig 6 metric: input feature bytes gathered per batch."""
    if isinstance(batch_or_cap, (int, np.integer)):
        return int(batch_or_cap) * feat_dim * itemsize
    return int(batch_or_cap.num_unique) * feat_dim * itemsize
