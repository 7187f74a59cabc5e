"""The ONE block-shuffle operator behind every ordering policy.

The paper's COMM-RAND (§4.1) and the LM corpus shuffler are the same
algorithm over different block definitions (graph communities vs corpus
shards): shuffle blocks as wholes, merge consecutive groups of
``max(1, round(mix * n_blocks))`` shuffled blocks into super-blocks, then
shuffle WITHIN each super-block. ``mix=0`` keeps every block contiguous
(maximum locality); ``mix=1`` degenerates to a full uniform shuffle.

A copy of `repro/batching/order.py` (pure numpy): the same epoch words
give the same orders in both packages.

Randomness is COUNTER-BASED: each epoch draws two uint32 key words from
the caller's Generator (`epoch_words`, the ONLY consumption of Generator
state) and every shuffle decision is a murmur-style hash of those words
with a position counter, resolved by stable argsort. That makes the whole
epoch permutation a closed-form function of `(words, static layout)`,
which a device mirror can recompute bit for bit.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

# murmur3-finalizer multipliers
MIX_A = 0x85EBCA6B
MIX_B = 0xC2B2AE35
# per-stage salts so block-level and element-level decisions are
# independent streams of the same two epoch words
SALT_PERM = 0x9E3779B9        # whole-set permutations (rand / labor roots)
SALT_BLOCK = 0x7F4A7C15       # block-as-a-whole shuffle
SALT_ELEM = 0x94D049BB        # within-super-block shuffle


def epoch_words(rng: np.random.Generator) -> np.ndarray:
    """The one Generator draw per epoch: two uint32 key words. Every
    ordering decision hashes these — so the device mirror only needs the
    words, not the Generator."""
    return rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)


def hash_u32(idx: np.ndarray, words: np.ndarray, salt: int) -> np.ndarray:
    """Murmur-style mix of a position counter with the epoch words ->
    uint32 keys. Pure uint32 wraparound arithmetic."""
    x = np.asarray(idx).astype(np.uint32)
    for w in (np.uint32(words[0]) ^ np.uint32(salt), np.uint32(words[1])):
        x = x ^ w
        x = x * np.uint32(MIX_A)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(MIX_B)
        x = x ^ (x >> np.uint32(16))
    return x


def hash_perm(n: int, words: np.ndarray, salt: int = SALT_PERM) -> np.ndarray:
    """Permutation of arange(n): stable argsort of per-position hash keys."""
    return np.argsort(hash_u32(np.arange(n), words, salt), kind="stable")


def block_shuffle_perm(sizes: np.ndarray, mix: float,
                       words: np.ndarray) -> np.ndarray:
    """The block-shuffle as a pure permutation over element positions.

    `sizes[b]` is the length of block b; elements are indexed in
    block-concatenation order (block 0's elements first). Returns `perm`
    such that `concat(blocks)[perm]` is the shuffled epoch order:
    (1) blocks shuffled as wholes by block-level hash keys, (2) merged in
    consecutive groups of ``max(1, round(mix * n_blocks))`` into
    super-blocks, (3) elements shuffled within each super-block by
    element-level hash keys of their post-block-shuffle position.

    Fully vectorized (two stable argsorts).
    """
    sizes = np.asarray(sizes, np.int64)
    n = len(sizes)
    total = int(sizes.sum())
    if n == 0 or total == 0:
        return np.zeros(0, np.int64)
    # (1) block-as-a-whole shuffle: rank[b] = position of block b
    border = np.argsort(hash_u32(np.arange(n), words, SALT_BLOCK),
                        kind="stable")
    rank = np.empty(n, np.int64)
    rank[border] = np.arange(n)
    # (2) super-block of a block at shuffled rank r: r // m
    m = max(1, int(round(mix * n)))
    starts_shuf = np.zeros(n, np.int64)
    np.cumsum(sizes[border][:-1], out=starts_shuf[1:])
    # per element: its block, offset within the block, and position in the
    # post-block-shuffle concatenation
    block_of = np.repeat(np.arange(n), sizes)
    block_start = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=block_start[1:])
    off_in_block = np.arange(total) - block_start[block_of]
    elem_rank = rank[block_of]
    gpos = starts_shuf[elem_rank] + off_in_block
    sb = elem_rank // m
    # (3) within-super-block shuffle: stable sort by (super-block, hash of
    # post-shuffle position) — two stable passes == one lexicographic sort
    idx = np.argsort(hash_u32(gpos, words, SALT_ELEM), kind="stable")
    return idx[np.argsort(sb[idx], kind="stable")]


def community_groups(train_ids: np.ndarray,
                     communities: np.ndarray) -> List[np.ndarray]:
    """Training-set node ids grouped per community (ascending comm id)."""
    comm = communities[train_ids]
    order = np.argsort(comm, kind="stable")
    sorted_ids = train_ids[order]
    sorted_comm = comm[order]
    cuts = np.flatnonzero(np.diff(sorted_comm)) + 1
    return np.split(sorted_ids, cuts)


def block_shuffle(blocks: Sequence[np.ndarray], mix: float,
                  rng: np.random.Generator) -> np.ndarray:
    """blocks -> shuffled super-blocks -> intra-shuffled concatenation.

    (1) shuffle blocks as wholes, (2) merge consecutive groups of
    ``max(1, round(mix * len(blocks)))`` into super-blocks, (3) shuffle the
    contents of each super-block. Draws exactly one `epoch_words` pair from
    `rng`, so a fixed seed gives a reproducible epoch order.
    """
    n = len(blocks)
    if n == 0:
        return np.zeros(0, np.int64)
    words = epoch_words(rng)
    flat = np.concatenate(blocks)
    sizes = np.fromiter((len(b) for b in blocks), np.int64, count=n)
    return flat[block_shuffle_perm(sizes, mix, words)]


def make_batches(order: np.ndarray, batch_size: int,
                 drop_last: bool = False) -> np.ndarray:
    """Split an epoch order into (n_batches, batch_size); last batch padded
    with -1 unless drop_last."""
    n = len(order)
    if drop_last:
        n_batches = n // batch_size
        return order[:n_batches * batch_size].reshape(n_batches, batch_size)
    n_batches = (n + batch_size - 1) // batch_size
    out = np.full((n_batches, batch_size), -1, order.dtype)
    out.flat[:n] = order
    return out
