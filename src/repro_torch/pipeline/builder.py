"""`DeviceBatchBuilder`: batch construction from a device-resident epoch
order (`repro/pipeline/builder.py`).

The synchronous `BatchStream` path does host work per batch: slice a
numpy root array and copy it to the device (a copy from pageable memory,
which waits for the device's queue to reach it) before the sample and
dedup ops. This builder removes that per-batch host leg:

  * the EPOCH root order is computed on the device (`device_order`) and
    stays resident for the whole epoch as one -1-padded
    (num_batches * B,) buffer — one order computation per epoch, no
    per-batch transfer; the buffer is allocated once and refreshed in
    place every epoch (the reference donates the previous one);
  * `build(epoch, pos)` takes batch `pos`'s roots out of that buffer on
    the device (`batching.stream.batch_roots`: a row gather at a position
    that rides in as data, so a build issues the same ops at every
    cursor) and runs the stream's own build body
    (`batching.stream.build_at`: `_build_batch_impl` with one
    `cursor_generator(..., SALT_SAMPLE)` per hop), so the `MiniBatch` is
    bit-exact against `BatchStream.build` at the same cursor.

  * a shared-randomness sampler's state (LABOR's per-node ranks) is
    computed on the device once per EPOCH (`epoch_ranks`) and threaded
    into every build of the epoch.

Policies without a device order program take the numpy `epoch_order`
once per epoch (one copy per epoch, not per batch, that does not wait).

Builds are serialised by a lock (a restarted producer may overlap the
last build of the one it replaces), and a build on another CUDA stream
than the previous one first waits for that stream, so the in-place order
refresh never races a read.

`stage_times` is the per-stage microbenchmark (roots prep / neighbour
sample / dedup+remap): CUDA events on the card, `perf_counter` on the CPU.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import sampling
from repro_torch.batching.policy import as_policy
from repro_torch.batching.stream import (SALT_SAMPLE, _device_inputs,
                                         batch_roots, build_at,
                                         cursor_generator, shared_words,
                                         to_device_int32)
from repro_torch.core import minibatch as mb
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.graphs.csr import DeviceGraph, Graph
from repro_torch.obs import trace as obs_trace
from repro_torch.pipeline.device_order import (OrderSpec, device_epoch_order,
                                               epoch_words_for)
from repro_torch.resilience import faults


class DeviceBatchBuilder:
    """Per-(epoch, pos) `MiniBatch` factory with a device-resident epoch
    order: `build(epoch, pos)` == `stream.build(root_batches(epoch)[pos],
    epoch, pos)` bit for bit."""

    def __init__(self, graph: Graph, policy, batch_size: int, fanouts,
                 caps, *, seed: int = 0, drop_last: bool = False,
                 sampler=None, device_graph: Optional[DeviceGraph] = None,
                 labels: Optional[torch.Tensor] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.graph = graph
        self.policy = as_policy(policy)
        self.batch_size = int(batch_size)
        self.fanouts = tuple(fanouts)
        self.caps = tuple(caps)
        self.seed = seed
        self.drop_last = drop_last
        self.sampler = sampling.resolve(
            sampler, lambda: sampling.for_policy(self.policy))
        self.g, self.labels = _device_inputs(graph, self.device,
                                             device_graph, labels)
        T = len(graph.train_ids)
        self.num_batches = T // self.batch_size if drop_last \
            else -(-T // self.batch_size)
        self.padded_len = self.num_batches * self.batch_size
        try:
            self.spec = OrderSpec.for_policy(graph, self.policy, self.device)
        except NotImplementedError:
            self.spec = None            # host numpy order, once per epoch
        self._buf: Optional[torch.Tensor] = None   # the padded order
        self._order_epoch = -1
        self._ranks = (-1, None)        # (epoch, shared sampler state)
        self._lock = threading.Lock()
        self._stream = None             # CUDA stream of the last build

    @classmethod
    def from_stream(cls, stream) -> "DeviceBatchBuilder":
        """A builder sharing a `BatchStream`'s graph, sampler and
        derivations (the same device graph and labels tensors)."""
        return cls(stream.graph, stream.policy, stream.batch_size,
                   stream.fanouts, stream.caps, seed=stream.seed,
                   drop_last=stream.drop_last, sampler=stream.sampler,
                   device_graph=stream.g, labels=stream.labels,
                   device=stream.device)

    # -- per-epoch device state ---------------------------------------------
    def epoch_roots(self, epoch: int) -> torch.Tensor:
        """The (num_batches * B,) device-resident root order for `epoch`,
        -1 padded (recomputed once per epoch)."""
        if self._order_epoch == epoch:
            return self._buf
        with obs_trace.span("epoch_order", cat="build", epoch=epoch):
            return self._epoch_roots_fresh(epoch)

    def _epoch_roots_fresh(self, epoch: int) -> torch.Tensor:
        if self.spec is not None:
            order = device_epoch_order(self.spec,
                                       epoch_words_for(self.seed, epoch))
        else:
            rng = np.random.default_rng((self.seed, epoch))
            order = to_device_int32(self.policy.epoch_order(
                self.graph.train_ids, self.graph.communities, rng),
                self.device)
        order = order[:self.padded_len]            # drop_last truncation
        if self._buf is None:
            self._buf = torch.full((self.padded_len,), -1,
                                   dtype=torch.int32, device=self.device)
        # the order's length is the same every epoch, so the -1 tail
        # written at allocation stays
        self._buf[:order.shape[0]].copy_(order)
        self._order_epoch = epoch
        return self._buf

    def epoch_ranks(self, epoch: int) -> Optional[torch.Tensor]:
        """Shared-randomness sampler state for `epoch` (LABOR's per-node
        ranks), computed on the device once and threaded into every build
        of the epoch; None for samplers without one."""
        if self._ranks[0] != epoch:
            self._ranks = (epoch, mb.sampler_epoch_ctx(
                self.sampler, shared_words(self.seed, epoch), self.g))
        return self._ranks[1]

    def _follow_stream(self) -> None:
        """Order this build after the previous one when it ran on another
        CUDA stream (the order buffer is refreshed in place)."""
        if self.device.type != "cuda":
            return
        cur = torch.cuda.current_stream(self.device)
        if self._stream is not None and self._stream != cur:
            cur.wait_stream(self._stream)
        self._stream = cur

    # -- the build ----------------------------------------------------------
    def build(self, epoch: int, pos: int) -> mb.MiniBatch:
        """MiniBatch for cursor (epoch, pos): the roots sliced on the
        device, no per-batch host-to-device transfer."""
        if not 0 <= pos < self.num_batches:
            raise IndexError(
                f"pos {pos} out of range for {self.num_batches} batches")
        # chaos site (repro_torch.resilience): an armed plan makes this
        # build raise InjectedFault — in the async pipeline that kills the
        # producer thread, which the consumer's watchdog absorbs by
        # restarting from the same cursor (bit-exact: builds are pure)
        faults.maybe_raise("batch_build", epoch=epoch, pos=pos)
        with obs_trace.span("batch_build", cat="build", epoch=epoch,
                            pos=pos), self._lock:
            self._follow_stream()
            roots = batch_roots(self.epoch_roots(epoch), pos,
                                self.batch_size)
            ranks = self.epoch_ranks(epoch)
            if ranks is not None and self._stream is not None:
                # a restarted producer's stream reads the ranks another
                # stream made: the allocator must not reuse them meanwhile
                ranks.record_stream(self._stream)
            return build_at(self.g, roots, self.labels, self.fanouts,
                            self.caps, self.sampler, self.seed, epoch, pos,
                            ranks)


# ---------------------------------------------------------------------------
# per-stage microbenchmark (roots / sample / dedup)
# ---------------------------------------------------------------------------
def _time_us(fn, device: torch.device, iters: int) -> float:
    """Best-of-`iters` time of `fn()` in µs: CUDA events around each call
    on the card, `perf_counter` on the CPU (after one warm-up call)."""
    fn()
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        else:
            # analysis: allow[no-wall-clock] -- stage-timing instrumentation; timings are reported, never fed back into batch construction
            t0 = time.perf_counter()
            fn()
            # analysis: allow[no-wall-clock] -- stage-timing instrumentation; timings are reported, never fed back into batch construction
            best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def stage_times(g: DeviceGraph, roots, labels_all, fanouts, caps, sampler,
                *, seed: int = 0, epoch: int = 0, pos: int = 0,
                iters: int = 10) -> dict:
    """Best-of-`iters` time (µs) per build stage of the batch at cursor
    (epoch, pos) for `roots`, on its realized levels:

      roots_us    root mask + sort (level-0 prep)
      sample_us   all hops' neighbour draws and sampling (LABOR's ranks,
                  made once an epoch, are not in it)
      dedup_us    concat + capped unique + position remap per hop

    The stages run on the same intermediates the builder produces."""
    fanouts, caps = tuple(fanouts), tuple(caps)
    sampler = sampling.resolve(sampler)
    N = g.num_nodes
    roots = to_device_int32(roots, g.device)
    ranks = mb.sampler_epoch_ctx(sampler, shared_words(seed, epoch), g)
    kw = {} if ranks is None else {"ranks": ranks}
    batch = build_at(g, roots, labels_all, fanouts, caps, sampler, seed,
                     epoch, pos, ranks)
    levels = batch.levels[:-1]

    def roots_fn():
        return torch.sort(torch.where(roots >= 0, roots, N)
                          .to(torch.int32)).values

    def sample_fn():
        out = []
        for h, fan in enumerate(fanouts):
            gen = cursor_generator(g.device, seed, epoch, pos, h,
                                   SALT_SAMPLE)
            u = sampler.draw(gen, levels[h].shape[0], fan)
            out.append(sampler.sample(g, levels[h], fan, *u, **kw))
        return out

    srcs = sample_fn()

    def dedup_fn():
        out = []
        for h, cap in enumerate(caps):
            prev, s = levels[h], srcs[h][0].reshape(-1)
            nxt = mb._unique_capped(torch.cat([prev, s]), cap, N)
            out.append((nxt, mb._positions(nxt, prev),
                        mb._positions(nxt, s)))
        return out

    return {"roots_us": _time_us(roots_fn, g.device, iters),
            "sample_us": _time_us(sample_fn, g.device, iters),
            "dedup_us": _time_us(dedup_fn, g.device, iters)}
