"""Resumable streams of `MiniBatch`es (`repro/batching/stream.py:50-251`).

`BatchStream` owns the per-epoch root ordering (via a `BatchPolicy`), the
batch builder, and an explicit `Cursor(epoch, pos)`.

Determinism contract: everything is derived from `(seed, epoch, pos)` —
the numpy epoch order from `default_rng((seed, epoch))` (equal to the
reference's), and one `torch.Generator` on the stream's device per
(batch, hop), seeded with a 64-bit pure function of
`(seed, epoch, pos, hop, salt)` (`cursor_generator`). A stream restored at
a cursor therefore rebuilds the same batch bit for bit. The generators are
the device's own (Philox on CUDA, MT19937 on the CPU), so a CUDA stream
and a CPU stream with the same seed draw different uniforms; the reference's
threefry draws are not reproduced (the parity tests inject them instead).
Shared-randomness samplers (LABOR) draw nothing per batch: they hash node
ids with two uint32 epoch words, `shared_words(seed, epoch)` (numpy's
SeedSequence of `(seed, epoch, 0, 0, SALT_LABOR)`), into ranks computed
once per epoch on the stream's device (`epoch_ctx`). The reference hashes
the raw words of its threefry epoch key instead; handed those words, the
port's ranks and picks are the reference's.

The stream carries the feature cache (`cache=`) its consumers read layer-0
features through. `_take(epoch, pos)` is the override point of the async
pipeline: `repro_torch.pipeline.AsyncBatchStream` hands out the same
batches from a producer thread that builds them on a CUDA side stream from
a device-resident epoch order (`GNNTrainer(pipeline="async")`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import featcache, sampling
from repro_torch.batching.order import make_batches
from repro_torch.batching.policy import BatchPolicy, as_policy
from repro_torch.core import minibatch as mb
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.graphs.csr import DeviceGraph, Graph

# stream salts: independent generator families over the same cursor
SALT_SAMPLE = 0         # per-(batch, hop) neighbor-sampling uniforms
SALT_DROPOUT = 1        # per-(batch, layer) dropout masks
SALT_EVAL = 2           # per-(chunk, hop) evaluation sampling
SALT_LABOR = 3          # per-epoch words of shared-randomness samplers
SALT_LABOR_EVAL = 4     # ... and the evaluation stream's words


def cursor_seed(seed: int, epoch: int, pos: int, hop: int,
                salt: int) -> int:
    """A 63-bit generator seed that is a pure function of its arguments
    (numpy's SeedSequence hash of the tuple)."""
    words = np.random.SeedSequence(
        (seed, epoch, pos, hop, salt)).generate_state(2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & ((1 << 63) - 1)


def shared_words(seed: int, epoch: int,
                 salt: int = SALT_LABOR) -> np.ndarray:
    """The two uint32 epoch words a shared-randomness sampler (LABOR)
    hashes node ids with: a pure function of (seed, epoch)."""
    return np.random.SeedSequence(
        (seed, epoch, 0, 0, salt)).generate_state(2, np.uint32)


def cursor_generator(device, seed: int, epoch: int, pos: int, hop: int,
                     salt: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(cursor_seed(seed, epoch, pos, hop, salt))
    return gen


@dataclass
class Cursor:
    """Stream position: epoch number + batch index within the epoch."""
    epoch: int = 0
    pos: int = 0

    def state(self) -> dict:
        return {"epoch": self.epoch, "pos": self.pos}

    @staticmethod
    def from_state(d) -> "Cursor":
        return Cursor(int(d["epoch"]), int(d["pos"]))


def build_at(g: DeviceGraph, roots: torch.Tensor, labels: torch.Tensor,
             fanouts, caps, sampler, seed: int, epoch: int, pos: int,
             ranks: Optional[torch.Tensor] = None) -> mb.MiniBatch:
    """The static-shape batch for device `roots` (int32, -1 padded) at
    cursor (epoch, pos): one generator per hop from `cursor_generator`,
    and for a shared-randomness sampler the epoch's `ranks` (of
    `shared_words(seed, epoch)`, computed once an epoch by the caller).
    The one build body of `BatchStream.build` and of
    `pipeline.DeviceBatchBuilder.build`."""
    def draw(hop, M, fanout):
        gen = cursor_generator(g.device, seed, epoch, pos, hop, SALT_SAMPLE)
        return sampler.draw(gen, M, fanout)

    return mb._build_batch_impl(g, roots, labels, fanouts, caps, sampler,
                                draw, ranks)


def _device_inputs(graph: Graph, device: torch.device,
                   device_graph: Optional[DeviceGraph],
                   labels: Optional[torch.Tensor]):
    g = device_graph or DeviceGraph.from_graph(graph, device)
    if g.device != device:
        raise ValueError(f"device_graph lives on {g.device}, not {device}")
    labels = labels if labels is not None else \
        torch.as_tensor(graph.labels, dtype=torch.int32).to(device)
    return g, labels


class BatchStream:
    """Policy-driven, cursor-resumable stream of `MiniBatch`es."""

    def __init__(self, graph: Graph, policy, batch_size: int, fanouts,
                 caps, *, seed: int = 0, cursor: Optional[Cursor] = None,
                 drop_last: bool = False, sampler=None,
                 device_graph: Optional[DeviceGraph] = None,
                 labels: Optional[torch.Tensor] = None,
                 cache=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.graph = graph
        self.policy: BatchPolicy = as_policy(policy)
        self.batch_size = batch_size
        self.fanouts = tuple(fanouts)
        self.caps = tuple(caps)
        self.seed = seed
        self.cursor = cursor or Cursor()
        self.drop_last = drop_last
        # sampler=None binds the policy's own sampler_spec()
        self.sampler = sampling.resolve(
            sampler, lambda: sampling.for_policy(self.policy))
        self.g, self.labels = _device_inputs(graph, self.device,
                                             device_graph, labels)
        # the device feature cache riding with the stream: any
        # `featcache.as_cache` spec (a plan, or an admission name built
        # here against this stream's policy and shape, on its device)
        self.cache = featcache.as_cache(
            cache, graph, policy=self.policy, batch_size=batch_size,
            fanouts=self.fanouts, seed=seed, device=self.device)
        self._order_cache = (-1, None)        # (epoch, (n_batches, B) roots)
        self._epoch_ctx = (-1, None)          # (epoch, shared sampler state)

    # -- deterministic derivations ------------------------------------------
    def root_batches(self, epoch: int) -> np.ndarray:
        """Root-id batches for `epoch` (cached for the current epoch)."""
        if self._order_cache[0] != epoch:
            rng = np.random.default_rng((self.seed, epoch))
            order = self.policy.epoch_order(
                self.graph.train_ids, self.graph.communities, rng)
            self._order_cache = (epoch, make_batches(
                order, self.batch_size, self.drop_last))
        return self._order_cache[1]

    def num_batches(self, epoch: int = None) -> int:
        n = len(self.graph.train_ids)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def epoch_ctx(self, epoch: int):
        """Per-epoch shared sampler state (LABOR's node ranks), computed
        once per epoch on the stream's device; None for other samplers."""
        if self._epoch_ctx[0] != epoch:
            self._epoch_ctx = (epoch, mb.sampler_epoch_ctx(
                self.sampler, shared_words(self.seed, epoch), self.g))
        return self._epoch_ctx[1]

    def build(self, roots: np.ndarray, epoch: int, pos: int) -> mb.MiniBatch:
        """The static-shape batch for these roots at cursor (epoch, pos)."""
        r = torch.as_tensor(np.asarray(roots), dtype=torch.int32)
        return build_at(self.g, r.to(self.device), self.labels, self.fanouts,
                        self.caps, self.sampler, self.seed, epoch, pos,
                        self.epoch_ctx(epoch))

    # -- iteration -----------------------------------------------------------
    def _take(self, epoch: int, pos: int) -> mb.MiniBatch:
        """Produce batch (epoch, pos) — the override point for async
        streams. The base class builds it from the numpy epoch order."""
        return self.build(self.root_batches(epoch)[pos], epoch, pos)

    def epoch(self) -> Iterator[mb.MiniBatch]:
        """Yield the REMAINDER of the current epoch (all of it when the
        cursor sits at pos 0), then advance the cursor to the next epoch.
        After each yield the cursor already points at the next batch."""
        nb = self.num_batches(self.cursor.epoch)
        if nb and self.cursor.pos >= nb:
            # a consumer stopped exactly on the epoch boundary: normalize
            self.cursor.epoch += 1
            self.cursor.pos = 0
            nb = self.num_batches(self.cursor.epoch)
        if nb == 0:
            raise ValueError(
                f"epoch {self.cursor.epoch} has no batches "
                f"({len(self.graph.train_ids)} train ids, batch_size="
                f"{self.batch_size}, drop_last={self.drop_last})")
        e = self.cursor.epoch
        while self.cursor.epoch == e and self.cursor.pos < nb:
            pos = self.cursor.pos
            batch = self._take(e, pos)
            self.cursor.pos += 1
            yield batch
        if self.cursor.epoch == e:            # exhausted, not broken out of
            self.cursor.epoch += 1
            self.cursor.pos = 0

    def __iter__(self) -> Iterator[mb.MiniBatch]:
        while True:
            yield from self.epoch()


def eval_batches(graph: Graph, ids: np.ndarray, batch_size: int, fanouts,
                 caps, p: float = 0.5, *, seed: int = 0, sampler=None,
                 device_graph: Optional[DeviceGraph] = None,
                 labels: Optional[torch.Tensor] = None,
                 device: DeviceLike = None) -> Iterator[mb.MiniBatch]:
    """Deterministic sequential batches over `ids` (padded with -1).
    Generators derive from (seed, chunk index, hop) only, so evaluation
    never perturbs training state. `sampler=None` keeps the biased
    two-phase draw at `p` (the uniform-eval contract). A shared-randomness
    sampler hashes with words of `(seed, SALT_LABOR_EVAL)` for every
    chunk."""
    dev = resolve_device(device)
    g, labels = _device_inputs(graph, dev, device_graph, labels)
    fanouts, caps = tuple(fanouts), tuple(caps)
    sampler = sampling.resolve(
        sampler, lambda: sampling.make_sampler("biased", p=float(p)))
    ranks = mb.sampler_epoch_ctx(sampler,
                                 shared_words(seed, 0, SALT_LABOR_EVAL), g)
    for j, i in enumerate(range(0, len(ids), batch_size)):
        pad = np.full(batch_size, -1, np.int64)
        chunk = ids[i:i + batch_size]
        pad[:len(chunk)] = chunk

        def draw(hop, M, fanout, j=j):
            gen = cursor_generator(dev, seed, 0, j, hop, SALT_EVAL)
            return sampler.draw(gen, M, fanout)

        roots = torch.as_tensor(pad, dtype=torch.int32).to(dev)
        yield mb._build_batch_impl(g, roots, labels, fanouts, caps, sampler,
                                   draw, ranks)
