"""Host-side data pipeline for the LM trainer (`repro/data/pipeline.py`),
numpy only, copied so that the port imports nothing of the reference.

`BlockShuffler` is the generic form of the paper's biased root
partitioning: the corpus is treated as blocks (shards / domains /
communities); blocks are shuffled as wholes, groups of `mix` blocks merge
into super-blocks whose contents are shuffled, giving shard-local read
locality with controlled randomness. The operator itself is the port's
`batching.order.block_shuffle`.

The stream carries an explicit cursor (epoch, position), the shared
`batching.Cursor`, that is part of every checkpoint; resume is bit-exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from repro_torch.batching.order import block_shuffle
from repro_torch.batching.stream import Cursor  # noqa: F401 (re-export)


@dataclass
class BlockShuffler:
    num_items: int
    block_size: int
    mix: float = 0.125            # fraction of blocks per super-block
    mode: str = "block"           # rand | block | none
    seed: int = 0

    def epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        idx = np.arange(self.num_items)
        if self.mode == "none":
            return idx
        if self.mode == "rand":
            return rng.permutation(idx)
        n_blocks = (self.num_items + self.block_size - 1) // self.block_size
        return block_shuffle(np.array_split(idx, n_blocks), self.mix, rng)


class SyntheticTokens:
    """Deterministic synthetic LM corpus: Zipfian tokens with local
    structure (so the loss decreases measurably)."""

    def __init__(self, vocab: int, num_docs: int = 4096, doc_len: int = 1024,
                 seed: int = 0):
        self.vocab = vocab
        self.num_docs = num_docs
        self.doc_len = doc_len
        self.seed = seed

    def doc(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        base = rng.zipf(1.5, self.doc_len).astype(np.int64)
        tok = base % (self.vocab - 2) + 1
        # inject a repeated local pattern -> learnable bigram structure
        tok[1::2] = (tok[::2][: len(tok[1::2])] * 7 + 3) % (self.vocab - 2) + 1
        return tok


class LMStream:
    """Batches of (tokens, labels) with block-shuffled doc order and a
    resumable cursor."""

    def __init__(self, corpus: SyntheticTokens, batch: int, seq: int,
                 shuffler: BlockShuffler = None, cursor: Cursor = None):
        self.corpus = corpus
        self.batch = batch
        self.seq = seq
        self.shuffler = shuffler or BlockShuffler(corpus.num_docs, 64)
        self.cursor = cursor or Cursor()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            order = self.shuffler.epoch_order(self.cursor.epoch)
            while self.cursor.pos + self.batch <= len(order):
                ids = order[self.cursor.pos:self.cursor.pos + self.batch]
                toks = np.stack([
                    np.resize(self.corpus.doc(i), self.seq + 1)
                    for i in ids])
                self.cursor.pos += self.batch
                yield toks[:, :-1].astype(np.int32), \
                    toks[:, 1:].astype(np.int32)
            self.cursor.epoch += 1
            self.cursor.pos = 0
