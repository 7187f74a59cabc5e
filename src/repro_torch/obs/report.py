"""Trace analysis: overlap, stall attribution, per-epoch rollups
(`repro/obs/report.py`; pure Python, copied, so both packages give the
same report dict for the same events).

Consumes the JSONL span traces `obs.trace.Tracer` writes:

  producer/consumer overlap fraction
      wall-clock time the async producer thread spent building batches
      WHILE a consumer train step was in flight, as a fraction of total
      producer busy time. The point of `repro_torch.pipeline`'s async
      prefetcher is that this is > 0 (batch construction hides behind
      the step); `chip_smoke.py` gates it on a traced run.

  stall attribution by stage
      total blocked time per wait site ("queue_get_wait" = consumer
      starved, "queue_put_wait" = producer backpressured — the healthy
      direction), as fractions of trace wall time.

  host-sync placement
      every host<->device read the trainer performs is traced as a
      cat="sync" span. A sync is *mid-epoch* when it starts before the
      final train step of its enclosing epoch span — anywhere but the
      epoch/checkpoint boundary. The gate is `mid_epoch_count == 0` on a
      traced async run.

  per-epoch span rollups
      per epoch: step count plus {span name -> count, total time}.

All computations are pure functions over the event list, unit-tested on
synthetic span sets (tests/test_torch_obs.py).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.trace import EVENT_KEYS, TRACE_SCHEMA_VERSION

Interval = Tuple[float, float]


# ---------------------------------------------------------------------------
# loading + schema conformance
# ---------------------------------------------------------------------------
def load_trace(path: str, include_meta: bool = False) -> List[dict]:
    """Parse a JSONL trace. Raises ValueError on an unparsable line —
    a torn trace should fail loudly, not analyze half a run."""
    events = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: bad trace line: {e}") \
                    from e
            if ev.get("ph") == "M" and not include_meta:
                continue
            events.append(ev)
    return events


def validate_events(events: Iterable[dict]) -> List[str]:
    """Chrome-trace conformance problems ([] = clean): every event has
    name/cat/ph/ts/pid/tid, complete events carry a non-negative dur,
    args (when present) is a dict."""
    problems = []
    for i, ev in enumerate(events):
        for k in EVENT_KEYS:
            if k not in ev:
                problems.append(f"event {i}: missing {k!r}: {ev}")
        if ev.get("ph") == "X":
            if "dur" not in ev:
                problems.append(f"event {i}: 'X' event without dur: {ev}")
            elif ev["dur"] < 0:
                problems.append(f"event {i}: negative dur: {ev}")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i}: args not a dict: {ev}")
    return problems


def to_chrome(events: List[dict], path: str) -> str:
    """Write the `{"traceEvents": [...]}` wrapper ui.perfetto.dev and
    chrome://tracing open directly."""
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return path


# ---------------------------------------------------------------------------
# interval arithmetic (all in microseconds, as traced)
# ---------------------------------------------------------------------------
def _spans(events: Iterable[dict], cat: Optional[str] = None,
           name: Optional[str] = None) -> List[dict]:
    return [ev for ev in events if ev.get("ph") == "X"
            and (cat is None or ev.get("cat") == cat)
            and (name is None or ev.get("name") == name)]


def merge_intervals(ivals: Iterable[Interval]) -> List[Interval]:
    """Union of possibly-overlapping intervals as a sorted disjoint list."""
    out: List[Interval] = []
    for lo, hi in sorted(ivals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def intersect_total(a: List[Interval], b: List[Interval]) -> float:
    """Total length of the intersection of two disjoint sorted lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _busy(events: Iterable[dict], cat: str) -> List[Interval]:
    return merge_intervals(
        [(ev["ts"], ev["ts"] + ev["dur"]) for ev in _spans(events, cat)])


def overlap_fraction(events: List[dict]) -> Dict:
    """Producer/consumer overlap: intersection of merged producer-thread
    build intervals (cat="producer") with merged consumer step intervals
    (cat="step"), normalized by producer busy time. A sync pipeline has
    no producer spans at all -> 0.0 by construction."""
    prod = _busy(events, "producer")
    cons = merge_intervals(_busy(events, "step") + _busy(events, "device"))
    steps = _busy(events, "step")
    prod_total = sum(hi - lo for lo, hi in prod)
    step_total = sum(hi - lo for lo, hi in steps)
    ov = intersect_total(prod, steps)
    return {"producer_busy_s": prod_total / 1e6,
            "consumer_busy_s": step_total / 1e6,
            "overlap_s": ov / 1e6,
            "overlap_frac": ov / prod_total if prod_total > 0 else 0.0,
            "overlap_frac_device": (intersect_total(prod, cons)
                                    / prod_total if prod_total > 0
                                    else 0.0)}


def stall_attribution(events: List[dict]) -> Dict:
    """Blocked time per wait site (cat="wait"), with fractions of trace
    wall time — "where did the pipeline wait, and on what"."""
    wall = _wall_us(events)
    out: Dict[str, Dict] = {}
    for ev in _spans(events, "wait"):
        e = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        e["count"] += 1
        e["total_s"] += ev["dur"] / 1e6
    for e in out.values():
        e["frac_of_wall"] = (e["total_s"] * 1e6 / wall) if wall else 0.0
    return out


def _wall_us(events: List[dict]) -> float:
    xs = [ev for ev in events if "ts" in ev and ev.get("ph") != "M"]
    if not xs:
        return 0.0
    lo = min(ev["ts"] for ev in xs)
    hi = max(ev["ts"] + ev.get("dur", 0.0) for ev in xs)
    return hi - lo


# ---------------------------------------------------------------------------
# epoch rollups + mid-epoch sync gate
# ---------------------------------------------------------------------------
def epoch_rollups(events: List[dict]) -> List[Dict]:
    """Per epoch envelope span (name="epoch", cat="loop"): step count,
    {span name -> count/total_s} for every span starting inside it, and
    the mid-epoch sync verdict.

    A cat="sync" span is MID-EPOCH when it starts before the start of
    the epoch's last train step: the only sanctioned sync placement is
    the epoch/checkpoint boundary, which by construction begins with (or
    nests inside) the final step of the epoch. An epoch with no steps
    (resume landed exactly on a boundary) cannot have mid-epoch syncs.

    Envelopes are judged PER PID: a multi-replica trace (one pid per
    replica, `trace.Tracer.for_replica`) carries one "epoch" envelope
    per replica, and each is rolled up against its own pid's events
    only — rank 0 being clean never masks a mid-epoch sync on rank 1,
    and another replica's step cannot launder a sync as boundary-placed."""
    out = []
    for ep in sorted(_spans(events, "loop", "epoch"),
                     key=lambda ev: ev["ts"]):
        lo, hi = ep["ts"], ep["ts"] + ep["dur"]
        inside = [ev for ev in _spans(events)
                  if lo <= ev["ts"] <= hi and ev is not ep
                  and ev.get("pid") == ep.get("pid")]
        steps = [ev for ev in inside if ev.get("cat") == "step"]
        # no steps at all (resume landed on a boundary): everything in
        # the envelope IS the boundary, so nothing can be mid-epoch
        last_step_start = max((ev["ts"] for ev in steps), default=lo)
        mid = [ev for ev in inside if ev.get("cat") == "sync"
               and ev["ts"] < last_step_start]
        rollup: Dict[str, Dict] = {}
        for ev in inside:
            e = rollup.setdefault(ev["name"],
                                  {"count": 0, "total_s": 0.0})
            e["count"] += 1
            e["total_s"] += ev["dur"] / 1e6
        out.append({"epoch": ep.get("args", {}).get("epoch"),
                    "pid": ep.get("pid"),
                    "start_s": lo / 1e6, "dur_s": ep["dur"] / 1e6,
                    "n_steps": len(steps),
                    "spans": rollup,
                    "mid_epoch_syncs": len(mid),
                    "mid_epoch_sync_names": sorted({ev["name"]
                                                    for ev in mid})})
    return out


def sync_sites(events: List[dict]) -> Dict:
    out: Dict[str, Dict] = {}
    for ev in _spans(events, "sync"):
        e = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        e["count"] += 1
        e["total_s"] += ev["dur"] / 1e6
    return out


def analyze(events: List[dict]) -> Dict:
    """The full report `python -m repro_torch.obs` prints/serializes."""
    problems = validate_events(events)
    epochs = epoch_rollups(events)
    return {
        "schema": TRACE_SCHEMA_VERSION,
        "n_events": len(events),
        "n_threads": len({ev.get("tid") for ev in events}),
        "wall_s": _wall_us(events) / 1e6,
        "conformance_problems": problems,
        "overlap": overlap_fraction(events),
        "stalls": stall_attribution(events),
        "sync_sites": sync_sites(events),
        "epochs": epochs,
        "mid_epoch_sync_count": sum(e["mid_epoch_syncs"] for e in epochs),
        # per-pid gate: every replica's trace must be clean, not just
        # rank 0's — a nonzero entry names the offending pid directly
        "mid_epoch_sync_by_pid": _by_pid(epochs),
    }


def _by_pid(epochs: List[Dict]) -> Dict:
    out: Dict[str, int] = {}
    for e in epochs:
        k = str(e.get("pid"))
        out[k] = out.get(k, 0) + e["mid_epoch_syncs"]
    return out
