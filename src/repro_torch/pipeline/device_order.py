"""Per-epoch root orders computed on the device
(`repro/pipeline/device_order.py`).

`batching/order.py` computes every policy's per-epoch root permutation as
a closed-form function of two uint32 epoch words: murmur-mix a position
counter with the words, stable-argsort the keys. This module runs the SAME
computation on torch tensors, so the epoch's root order lives on the
device and never crosses the host boundary per batch.

Bit-match contract: for every registered policy (rand, norand, comm_rand,
clustergcn, labor),

    device_epoch_order(OrderSpec.for_policy(graph, policy, device),
                       epoch_words_for(seed, epoch))
 ==  policy.epoch_order(graph.train_ids, graph.communities,
                        np.random.default_rng((seed, epoch)))

element for element. Both sides hash identical counters with identical
constants and break ties with stable
sorts over identical input layouts. The uint32 wraparound arithmetic runs
in int64, masked to 32 bits at every step (`core.hash32`).

The static layout (community-sorted ids, block boundaries) is built ONCE
per (graph, policy) in `OrderSpec`; per epoch only the two words change,
and they ride into the device code as one (2,) int64 tensor
(`core.hash32.word_tensor`: one copy that does not wait), so every
epoch's program issues the same ops.
labor's roots are rand's whole-set permutation; clustergcn lists the
train roots by hash-shuffled community union.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.batching.order import (SALT_BLOCK, SALT_ELEM, SALT_PERM,
                                        community_groups, epoch_words)
from repro_torch.core.hash32 import hash_u32 as _hash_u32
from repro_torch.core.hash32 import word_tensor
from repro_torch.devices import DeviceLike, resolve_device


def epoch_words_for(seed: int, epoch: int) -> np.ndarray:
    """The two uint32 epoch words `BatchStream.root_batches` consumes:
    the first (and only) Generator draw of `default_rng((seed, epoch))`."""
    return epoch_words(np.random.default_rng((seed, epoch)))


def _stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices


def _order_perm(words, ids: torch.Tensor) -> torch.Tensor:
    """rand roots: ids under a hash-keyed whole-set permutation."""
    n = ids.shape[0]
    keys = _hash_u32(torch.arange(n, device=ids.device), words, SALT_PERM)
    return ids[_stable_argsort(keys)]


def _order_comm_rand(words, ids: torch.Tensor, sizes: torch.Tensor,
                     block_of: torch.Tensor, off_in_block: torch.Tensor,
                     m: int) -> torch.Tensor:
    """comm_rand: `block_shuffle_perm` on the device. `ids` is the
    community-sorted concatenation (block 0 first); `m` is the super-block
    size max(1, round(mix * n_blocks))."""
    n = sizes.shape[0]
    dev = ids.device
    bkey = _hash_u32(torch.arange(n, device=dev), words, SALT_BLOCK)
    border = _stable_argsort(bkey)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[border] = torch.arange(n, device=dev)
    starts_shuf = torch.zeros(n, dtype=torch.int64, device=dev)
    starts_shuf[1:] = torch.cumsum(sizes[border], 0)[:-1]
    elem_rank = rank[block_of]
    gpos = starts_shuf[elem_rank] + off_in_block
    sb = elem_rank // m
    # within-super-block shuffle: two stable passes == one lexicographic
    # sort by (super-block, hash of post-shuffle position)
    idx = _stable_argsort(_hash_u32(gpos, words, SALT_ELEM))
    idx = idx[_stable_argsort(sb[idx])]
    return ids[idx]


def _order_clustergcn(words, ids: torch.Tensor, comm_of: torch.Tensor,
                      n_comm: int, ppb: int) -> torch.Tensor:
    """clustergcn: hash-permute community ids, merge consecutive groups of
    `ppb` into unions, list train roots by (union, original position)."""
    dev = ids.device
    ckey = _hash_u32(torch.arange(n_comm, device=dev), words, SALT_PERM)
    corder = _stable_argsort(ckey)
    rank_c = torch.empty(n_comm, dtype=torch.int64, device=dev)
    rank_c[corder] = torch.arange(n_comm, device=dev)
    union = rank_c[comm_of] // ppb
    return ids[_stable_argsort(union)]


@dataclass(frozen=True)
class OrderSpec:
    """Static per-(graph, policy) layout for the device order programs.

    `ids` is the concatenation the per-epoch permutation is applied to:
    train_ids as-is for rand / labor / clustergcn, the community-sorted
    concatenation for norand / comm_rand. Built once at stream
    construction; per epoch only two words move.
    """
    kind: str                                 # the program to run
    ids: torch.Tensor                         # (T,) int32
    sizes: Optional[torch.Tensor] = None      # (n_blocks,) int64 [comm_rand]
    block_of: Optional[torch.Tensor] = None   # (T,) int64         [comm_rand]
    off_in_block: Optional[torch.Tensor] = None  # (T,) int64      [comm_rand]
    m: int = 1                                # super-block size   [comm_rand]
    comm_of: Optional[torch.Tensor] = None    # (T,) int64        [clustergcn]
    n_comm: int = 0                           #                   [clustergcn]
    ppb: int = 1                              # parts per batch   [clustergcn]

    @property
    def num_train(self) -> int:
        return int(self.ids.shape[0])

    @staticmethod
    def for_policy(graph, policy, device: DeviceLike = None) -> "OrderSpec":
        """The static layout of a registered policy, on `device`. Raises
        NotImplementedError for a policy without a device order program
        (the builder then takes the numpy order, once per epoch)."""
        name = getattr(policy, "name", None)
        if name not in ("rand", "labor", "norand", "comm_rand",
                        "clustergcn"):
            raise NotImplementedError(
                f"no device order program for policy {name!r}")
        dev = resolve_device(device)
        train = np.asarray(graph.train_ids)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        if name in ("rand", "labor"):
            return OrderSpec("rand", t(train, torch.int32))
        if name == "clustergcn":
            return OrderSpec(
                "clustergcn", t(train, torch.int32),
                comm_of=t(graph.communities[train]),
                n_comm=int(graph.communities.max()) + 1,
                ppb=int(policy.parts_per_batch))
        groups = community_groups(train, graph.communities)
        flat = np.concatenate(groups)
        if name == "norand":
            return OrderSpec("norand", t(flat, torch.int32))
        sizes = np.fromiter((len(g) for g in groups), np.int64,
                            count=len(groups))
        block_of = np.repeat(np.arange(len(groups)), sizes)
        starts = np.zeros(len(groups), np.int64)
        np.cumsum(sizes[:-1], out=starts[1:])
        off = np.arange(len(flat)) - starts[block_of]
        return OrderSpec(
            "comm_rand", t(flat, torch.int32), sizes=t(sizes),
            block_of=t(block_of), off_in_block=t(off),
            m=max(1, int(round(policy.mix * len(groups)))))


def device_epoch_order(spec: OrderSpec, words) -> torch.Tensor:
    """(T,) int32 root ids for one epoch, on the spec's device. `words` is
    `epoch_words_for(seed, epoch)` (two integers, copied to the device
    once without a wait) or their (2,) int64 tensor there."""
    if spec.kind == "norand":
        return spec.ids
    words = word_tensor(words, spec.ids.device)
    if spec.kind == "rand":
        return _order_perm(words, spec.ids)
    if spec.kind == "comm_rand":
        return _order_comm_rand(words, spec.ids, spec.sizes, spec.block_of,
                                spec.off_in_block, spec.m)
    if spec.kind == "clustergcn":
        return _order_clustergcn(words, spec.ids, spec.comm_of,
                                 spec.n_comm, spec.ppb)
    raise ValueError(spec.kind)


def order_bitmatch(graph, policy, seed: int = 0, epochs=(0, 1),
                   device: DeviceLike = None) -> bool:
    """True iff the device order equals the numpy policy order element for
    element for every epoch in `epochs`."""
    spec = OrderSpec.for_policy(graph, policy, device)
    for epoch in epochs:
        want = policy.epoch_order(graph.train_ids, graph.communities,
                                  np.random.default_rng((seed, epoch)))
        got = device_epoch_order(spec, epoch_words_for(seed, epoch))
        if not np.array_equal(got.cpu().numpy().astype(np.int64),
                              np.asarray(want)):
            return False
    return True
