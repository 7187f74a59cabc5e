"""`AsyncBatchStream`: depth-k background batch prefetching + watchdog
(`repro/pipeline/prefetch.py`).

A drop-in `BatchStream` whose batches come from a producer thread through
`DeviceBatchBuilder` (device-resident epoch order). A bounded queue of
depth `k` (default 2) applies backpressure: while the trainer dispatches
step i, the producer has already built batches i+1..i+k.

    consumer   | step i        | step i+1      | step i+2
    producer   | build i+1, i+2| build i+3     | ...

On a CUDA device the producer thread makes the stream's device current
(the current device is per thread) and builds under `torch.cuda.stream`
on a side stream of its own. Its first build waits for an event the
consumer recorded when it (re)started the producer, so everything the
consumer queued before (the graph, labels, a restored state) is visible.
Each batch goes into the queue with a `torch.cuda.Event` recorded after
its build; the consumer's current stream waits on that event, and every
tensor of the `MiniBatch` is `record_stream`-ed onto the consumer's
stream, so that the caching allocator cannot hand a batch's memory to the
producer's next build while the step still reads it. The kernels launch
on `torch.cuda.current_stream`, so they follow the same order. On the
CPU the same class runs with the thread and without streams. The GIL is
held only while Python runs: each op's C++ releases it, so the producer's
sampling overlaps the trainer's dispatch only partly on the host, and
fully on the device.

Determinism contract: identical to `BatchStream`. The producer walks the
same (epoch, pos) cursor arithmetic and every build is a pure function of
(seed, epoch, pos), so the delivered batch SEQUENCE is bit-exact against
the synchronous stream — including after an external cursor reset
(checkpoint resume, guard rollback): `_take` sees that the requested
cursor is not what the producer is about to deliver and restarts the
producer from it, dropping in-flight work.

Watchdog: the producer heartbeats at every loop turn and while blocked
on a full queue; the consumer, whenever its queue wait comes up empty,
checks for a DEAD producer (thread exited — the real exception is stashed
on `_exc`) or a STALLED one (no heartbeat for `stall_timeout_s`). Either
way it restarts the producer from the cursor it is waiting on, with
exponential backoff (`restart_backoff_s * 2^attempt`) and a bounded
consecutive budget (`max_restarts`); past the budget the REAL producer
error is raised. Restarts are counted on `self.restarts` and, with a
`train.monitor.ResilienceMeter` attached (`meter=`), metered as
`producer_restarts`. Heartbeats pause during a long build, so
`stall_timeout_s` defaults high (60 s); `prime()` builds once
synchronously before a caller lowers it. Fault sites
(`repro_torch.resilience`): `producer_hang` stalls the producer without
heartbeats until a generation bump; `batch_build` faults raised inside
`DeviceBatchBuilder.build` surface through the dead-producer path.
There is no fallback to the synchronous path: a producer that cannot
start, or an event that fails, raises.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time

import torch

from repro_torch.batching.stream import BatchStream
from repro_torch.core import minibatch as mb
from repro_torch.obs import trace as obs_trace
from repro_torch.pipeline.builder import DeviceBatchBuilder
from repro_torch.resilience import faults

_POLL_S = 0.05          # producer put / consumer get poll for shutdown checks


def batch_tensors(batch: mb.MiniBatch):
    """Every tensor a `MiniBatch` holds."""
    yield from batch.levels
    yield from (batch.node_mask, batch.labels, batch.label_mask)
    for b in batch.blocks:
        yield from (b.src_pos, b.self_pos, b.edge_mask, b.dst_mask)


class AsyncBatchStream(BatchStream):
    """`BatchStream` with a depth-k background build queue.

    Same constructor plus `depth` (queue size, default 2) and the
    watchdog knobs (`stall_timeout_s`, `max_restarts`,
    `restart_backoff_s`, `meter`). Checkpointing is unchanged:
    `cursor.state()` / assigning a restored `Cursor` works mid-epoch with
    builds in flight.
    """

    def __init__(self, *args, depth: int = 2, stall_timeout_s: float = 60.0,
                 max_restarts: int = 3, restart_backoff_s: float = 0.05,
                 meter=None, **kwargs):
        super().__init__(*args, **kwargs)
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self.stall_timeout_s = stall_timeout_s
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.meter = meter          # optional ResilienceMeter
        self.restarts = 0           # lifetime watchdog restarts
        self.builder = DeviceBatchBuilder.from_stream(self)
        # the producer's own CUDA stream (None on the CPU)
        self._side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._queue = None          # queue.Queue of (epoch, pos, batch, event)
        self._thread = None
        self._stale = []            # replaced producers, exiting
        self._gen = 0               # bumped on restart; stale producers exit
        self._stop = threading.Event()
        self._next_out = None       # (epoch, pos) at the queue's head
        self._beat = None           # monotonic time of last producer beat
        self._exc = None            # stashed REAL producer exception
        self._consec_restarts = 0   # watchdog budget, reset on delivery

    # -- producer -----------------------------------------------------------
    def _advance(self, epoch: int, pos: int):
        """Cursor arithmetic of `epoch()`: next (epoch, pos) delivered."""
        if pos + 1 < self.num_batches(epoch):
            return epoch, pos + 1
        return epoch + 1, 0

    @contextlib.contextmanager
    def _on_side_stream(self):
        """The producer thread's device and stream (nothing on the CPU)."""
        if self._side is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            yield

    def _produce(self, epoch: int, pos: int, gen: int, q, ready) -> None:
        try:
            with self._on_side_stream():
                if ready is not None:
                    # what the consumer queued before this (re)start
                    torch.cuda.current_stream().wait_event(ready)
                self._produce_loop(epoch, pos, gen, q)
        except Exception as exc:        # surface build errors to consumer
            # stash the real exception BEFORE the queue handoff: if the
            # error put times out on a full queue, `_take` still raises the
            # true error instead of a generic "producer died"
            self._exc = exc
            try:
                q.put(("error", exc, None, None), timeout=1.0)
            except queue.Full:
                pass

    def _produce_loop(self, epoch: int, pos: int, gen: int, q) -> None:
        while not self._stop.is_set() and gen == self._gen:
            # analysis: allow[no-wall-clock] -- watchdog heartbeat: liveness only, never influences delivered batch data
            self._beat = time.monotonic()
            if self.num_batches(epoch) == 0:
                return          # the consumer raises; nothing to build
            if faults.fire("producer_hang", epoch=epoch,
                           pos=pos) is not None:
                # chaos site: stop heartbeating and producing until a
                # generation bump (watchdog restart or close) ends us
                while gen == self._gen and not self._stop.is_set():
                    time.sleep(_POLL_S)
                return
            # cat="producer": their wall-clock intersection with the
            # consumer's cat="step" spans IS the measured overlap
            with obs_trace.span("producer_build", cat="producer",
                                epoch=epoch, pos=pos):
                batch = self.builder.build(epoch, pos)
                ev = None
                if self._side is not None:
                    ev = torch.cuda.Event()
                    ev.record(self._side)
            with obs_trace.span("queue_put_wait", cat="wait", epoch=epoch,
                                pos=pos):
                while gen == self._gen and not self._stop.is_set():
                    # analysis: allow[no-wall-clock] -- watchdog heartbeat: liveness only, never influences delivered batch data
                    self._beat = time.monotonic()   # full queue: healthy
                    try:
                        q.put((epoch, pos, batch, ev), timeout=_POLL_S)
                        break
                    except queue.Full:
                        continue
            epoch, pos = self._advance(epoch, pos)

    def _restart(self, epoch: int, pos: int) -> None:
        self._gen += 1              # the in-flight producer drains and exits
        if self._thread is not None:
            self._stale = [t for t in self._stale if t.is_alive()]
            self._stale.append(self._thread)
        self._queue = queue.Queue(maxsize=self.depth)
        self._next_out = (epoch, pos)
        # analysis: allow[no-wall-clock] -- watchdog grace period on restart; batches remain pure in (epoch, pos)
        self._beat = time.monotonic()   # fresh grace period
        ready = None
        if self._side is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._thread = threading.Thread(
            target=self._produce,
            args=(epoch, pos, self._gen, self._queue, ready),
            name=f"AsyncBatchStream-{id(self):x}", daemon=True)
        self._thread.start()

    # -- consumer + watchdog ------------------------------------------------
    def _stalled(self) -> bool:
        return (self.stall_timeout_s is not None and self._beat is not None
                # analysis: allow[no-wall-clock] -- stall detection compares heartbeats; recovery replays the same cursor bit-exactly
                and time.monotonic() - self._beat > self.stall_timeout_s)

    def _recover(self, epoch: int, pos: int, reason: BaseException) -> None:
        """Watchdog action: restart the producer from the cursor we are
        waiting on (bit-exact: builds are pure in (epoch, pos)), with
        exponential backoff and a bounded consecutive budget. Past the
        budget, raise the stashed real producer error or the stall
        diagnosis."""
        if self._consec_restarts >= self.max_restarts:
            err = self._exc if self._exc is not None else reason
            self.close()
            raise err
        self._consec_restarts += 1
        self.restarts += 1
        if self.meter is not None:
            self.meter.note("producer_restarts", epoch=epoch, pos=pos,
                            reason=repr(reason))
        time.sleep(self.restart_backoff_s
                   * (2 ** (self._consec_restarts - 1)))
        self._exc = None
        self._restart(epoch, pos)

    def _handoff(self, batch: mb.MiniBatch, ev) -> mb.MiniBatch:
        """Make a batch built on the side stream safe to use on the
        consumer's current stream."""
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in batch_tensors(batch):
                t.record_stream(cur)
        return batch

    def _take(self, epoch: int, pos: int) -> mb.MiniBatch:
        if self._thread is None or self._next_out != (epoch, pos):
            # first use, or an external cursor reset (resume, rollback):
            # drop in-flight work and realign the producer. A DEAD but
            # still-aligned producer falls through to the loop below, so
            # its restart goes through `_recover` (metered, budgeted).
            self._restart(epoch, pos)
        # cat="wait": the time the CONSUMER blocked before this batch came
        # off the queue — the "consumer starved" stall site
        with obs_trace.span("queue_get_wait", cat="wait", epoch=epoch,
                            pos=pos):
            while True:
                q = self._queue
                try:
                    item = q.get(timeout=_POLL_S)
                except queue.Empty:
                    if self._thread is None or not self._thread.is_alive():
                        self._recover(epoch, pos, self._exc or RuntimeError(
                            "AsyncBatchStream producer died without output"))
                    elif self._stalled():
                        self._recover(epoch, pos, RuntimeError(
                            f"AsyncBatchStream producer heartbeat stalled "
                            f"> {self.stall_timeout_s}s at {(epoch, pos)}"))
                    continue
                if item[0] == "error":
                    self._recover(epoch, pos, item[1])
                    continue
                e, p, batch, ev = item
                if (e, p) != (epoch, pos):  # stale pre-restart leftover
                    continue
                self._consec_restarts = 0   # healthy delivery resets budget
                self._next_out = self._advance(epoch, pos)
                return self._handoff(batch, ev)

    def prime(self) -> "AsyncBatchStream":
        """Build the cursor's batch once, synchronously (and wait for the
        device): latency-sensitive callers prime BEFORE lowering
        `stall_timeout_s`, so that a slow first build is not taken for a
        hang."""
        c = self.cursor
        nb = self.num_batches(c.epoch)
        if nb > 0:
            self.builder.build(c.epoch, min(c.pos, nb - 1))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return self

    def close(self) -> None:
        """Stop the producer and drop queued work (idempotent)."""
        self._gen += 1
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            q = self._queue
            while t.is_alive():     # unblock a producer stuck on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=_POLL_S)
        for t in self._stale:       # replaced producers see the new gen
            t.join()
        self._stale = []
        self._queue = None
        self._next_out = None
        self._beat = None
        self._stop = threading.Event()   # close() then reuse => restart

    def __del__(self):
        try:
            self._stop.set()
            self._gen += 1
        except Exception:
            pass
