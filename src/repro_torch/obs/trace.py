"""Structured span tracing for the GNN training stack
(`repro/obs/trace.py`; pure Python, copied).

Every instrumented subsystem (batch builder, producer thread, trainer
step loop, checkpointing, cache refill) emits *spans* — named wall-clock
intervals tagged with a category and free-form args — into one global
`Tracer`. The on-disk format is the reference's Chrome-trace/Perfetto
JSONL (`TRACE_SCHEMA_VERSION`): one JSON event per line, each a complete
("ph": "X") or instant ("ph": "i") event with microsecond timestamps and
real pid/tid, so a trace answers "what was the producer thread doing
while the train step stalled?" by inspection. `python -m repro_torch.obs`
converts a trace to the `{"traceEvents": [...]}` wrapper ui.perfetto.dev
opens, and computes the overlap / stall report (`obs/report.py`).

Span taxonomy (categories):

  step      consumer train-step dispatch (`GNNTrainer._train_one`)
  build     device batch build / epoch-order refresh (`pipeline.builder`)
  producer  the async producer thread's build loop
            (`pipeline.prefetch._produce`)
  wait      blocked time: consumer queue get, producer queue put
  sync      host<->device reads (epoch / n-step flush, guard skip-counter
            read, cache-refill churn read, checkpoint save) — the analyzer
            gates that NONE of these occur mid-epoch
  device    accumulated device step timing (`DeviceStepTimer`)
  cache     dynamic-cache CLOCK refill (`featcache.dynamic.refill`)
  ckpt      checkpoint restore / rollback
  loop      epoch envelope (`run_epoch`)
  eval      evaluation pass

Zero-cost when disabled: the module-level tracer defaults to None and
`span()`/`instant()` return a shared no-op context manager without
allocating. Tracing never synchronises the device and never touches a
generator or batch data, so the loss trajectory is bit-identical with
tracing on and off (tests/test_torch_obs.py).

Device step timing without a sync: `DeviceStepTimer.note` records each
step's host dispatch timestamp (and keeps the step's un-read loss tensor),
and `flush` — called only right AFTER a host read the trainer already
makes (the epoch or n-step drain), which waits for the device — closes the
window into one "device_steps" span with the per-step mean in its args.
The timer itself never calls `torch.cuda.synchronize`, `.item()` or
`.cpu()`, and records no CUDA event: its window is host time from the
first dispatch to the end of that drain.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

TRACE_SCHEMA_VERSION = 1

# required keys of every emitted event; "X" events also carry "dur"
EVENT_KEYS = ("name", "cat", "ph", "ts", "pid", "tid")


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


class _Span:
    """One in-flight "X" (complete) event; the context manager
    `Tracer.span` returns."""
    __slots__ = ("_tracer", "_ev", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self._ev = {"name": name, "cat": cat, "ph": "X", "pid": tracer.pid,
                    "tid": threading.get_ident(), "args": args}
        self._t0 = 0.0

    def set(self, **args) -> "_Span":
        """Attach args discovered mid-span (e.g. a result count)."""
        self._ev["args"].update(args)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc) -> None:
        ev = self._ev
        ev["ts"] = self._t0
        ev["dur"] = _now_us() - self._t0
        self._tracer._emit(ev)


class _NoopSpan:
    """Shared do-nothing span: what `span()` hands out when tracing is
    disabled. Stateless, hence safe to share across threads."""
    __slots__ = ()

    def set(self, **args) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP = _NoopSpan()


class Tracer:
    """Buffered, thread-safe span collector writing Chrome-trace JSONL.

    `path=None` keeps events in memory only (read them back with
    `events()`); with a path, `flush()`/`close()` append the buffered
    events one JSON object per line. Timestamps are microseconds from
    `perf_counter_ns`; pid/tid are the real process/thread ids, so a
    multi-thread trace lays out one Perfetto track per thread.
    """

    def __init__(self, path: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.path = path
        self.pid = os.getpid()
        self.meta = dict(meta or {})
        self._lock = threading.Lock()
        self._buf: List[dict] = []
        self._all: List[dict] = []
        self._replica_views: Dict[int, "_ReplicaView"] = {}
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            # truncate + header: process metadata rides as an "M" event
            with open(path, "w") as f:
                f.write(json.dumps(self._meta_event()) + "\n")

    def _meta_event(self) -> dict:
        return {"name": "process_name", "cat": "__metadata", "ph": "M",
                "ts": 0, "pid": self.pid, "tid": 0,
                "args": dict(self.meta,
                             schema_version=TRACE_SCHEMA_VERSION)}

    # -- emission -----------------------------------------------------------
    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._buf.append(ev)
            self._all.append(ev)

    def span(self, name: str, cat: str = "host", **args) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        self._emit({"name": name, "cat": cat, "ph": "i", "ts": _now_us(),
                    "pid": self.pid, "tid": threading.get_ident(),
                    "s": "t", "args": args})

    def for_replica(self, r: int) -> "_ReplicaView":
        """A pid-view of this tracer for replica `r`: its events carry a
        pid distinct from the host process and from every other replica,
        so each replica lays out as its own Perfetto process track and the
        report's per-pid mid-epoch-sync gate judges each replica's timeline
        separately. The first use of a replica emits its "M" header."""
        view = self._replica_views.get(r)
        if view is None:
            view = self._replica_views[r] = _ReplicaView(self, r)
        return view

    # -- inspection / persistence -------------------------------------------
    def events(self) -> List[dict]:
        """All events emitted so far (flushed ones included), metadata
        header excluded."""
        with self._lock:
            return list(self._all)

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if self.path and buf:
            with open(self.path, "a") as f:
                for ev in buf:
                    f.write(json.dumps(ev) + "\n")

    def close(self) -> None:
        self.flush()


class _ReplicaView:
    """Per-replica pid facade over a `Tracer` (see `Tracer.for_replica`).
    Spans are emitted with explicit (ts, dur), reconstructed after the
    fact; emission never synchronises the device."""
    __slots__ = ("_tracer", "replica", "pid")

    def __init__(self, tracer: Tracer, r: int):
        self._tracer = tracer
        self.replica = r
        # distinct from the host pid and from every other replica view
        self.pid = tracer.pid * 1000 + r + 1
        tracer._emit({"name": "process_name", "cat": "__metadata",
                      "ph": "M", "ts": 0, "pid": self.pid, "tid": 0,
                      "args": {"name": f"replica {r}", "replica": r}})

    def emit_span(self, name: str, cat: str, ts: float, dur: float,
                  **args) -> None:
        self._tracer._emit({"name": name, "cat": cat, "ph": "X",
                            "ts": ts, "dur": dur, "pid": self.pid,
                            "tid": 0, "args": dict(args,
                                                   replica=self.replica)})

    def instant(self, name: str, cat: str = "host", **args) -> None:
        self._tracer._emit({"name": name, "cat": cat, "ph": "i",
                            "ts": _now_us(), "pid": self.pid, "tid": 0,
                            "s": "t",
                            "args": dict(args, replica=self.replica)})


# ---------------------------------------------------------------------------
# global tracer: the stack's call sites go through these free functions
# ---------------------------------------------------------------------------
_TRACER: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    """Make `tracer` the stack-wide tracer (visible from every thread)."""
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall() -> Optional[Tracer]:
    """Disable tracing; returns (and flushes) the previous tracer."""
    global _TRACER
    t, _TRACER = _TRACER, None
    if t is not None:
        t.flush()
    return t


def current() -> Optional[Tracer]:
    return _TRACER


class enabled:
    """`with trace.enabled("t.jsonl") as t:` — install for the block."""

    def __init__(self, path: Optional[str] = None, **meta):
        self.tracer = Tracer(path, meta=meta)

    def __enter__(self) -> Tracer:
        return install(self.tracer)

    def __exit__(self, *exc) -> None:
        if _TRACER is self.tracer:
            uninstall()
        else:                       # someone swapped tracers mid-block
            self.tracer.flush()


def span(name: str, cat: str = "host", **args):
    """A span on the installed tracer, or the shared no-op when tracing
    is disabled — the one line hot paths pay."""
    t = _TRACER
    if t is None:
        return NOOP
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "host", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


# ---------------------------------------------------------------------------
# device step timing without a sync
# ---------------------------------------------------------------------------
class DeviceStepTimer:
    """Accumulate per-step dispatch timestamps; close the window only
    after a host read the trainer already makes.

    `note(out)` is called once per train step right after dispatch: it
    records the host timestamp and keeps a reference to the step's un-read
    output tensor. Nothing waits here.

    `flush(site=...)` is called right AFTER the caller's own boundary
    read (epoch flush, n-step drain), which has waited for the device, and
    emits one "device_steps" span from the first dispatch to now, with `n`
    steps and the per-step mean in its args. The timer never calls
    `torch.cuda.synchronize`, `.item()` or `.cpu()`, so tracing adds no
    host<->device round trip.
    """

    def __init__(self):
        self._t0: Optional[float] = None
        self._n = 0
        self._last = None           # un-read output of the latest step

    def note(self, out: Any = None) -> None:
        if _TRACER is None:
            return
        if self._t0 is None:
            self._t0 = _now_us()
        self._n += 1
        self._last = out

    def flush(self, site: str = "epoch") -> None:
        """Emit the accumulated window (call AFTER the boundary read)."""
        t = _TRACER
        if t is None or self._t0 is None:
            self._t0, self._n, self._last = None, 0, None
            return
        end = _now_us()
        dur = end - self._t0
        n = self._n
        t._emit({"name": "device_steps", "cat": "device", "ph": "X",
                 "ts": self._t0, "dur": dur, "pid": t.pid,
                 "tid": threading.get_ident(),
                 "args": {"n": n, "site": site,
                          "per_step_us": dur / max(n, 1)}})
        self._t0, self._n, self._last = None, 0, None
